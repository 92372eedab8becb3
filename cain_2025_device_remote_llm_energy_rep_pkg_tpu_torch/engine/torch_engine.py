"""The PyTorch generation engine: the counterpart of ``JaxEngine``'s solo path.

``generate`` tokenizes, prefills into a bucketed contiguous KV cache (in
PREFILL_CHUNK-sized chunks for long prompts), optionally quantizes the
cache to int8 once, then decodes one token per step in a Python loop over
``forward`` + ``logits_for`` + ``sample_token``. Prefill and decode are
fenced with ``torch.cuda.synchronize()`` (the JAX engine's
``block_until_ready``), so ``prefill_s`` and ``decode_s`` time device work.

``generate_batch`` serves several requests in one decode loop: grouped
prefill per prompt bucket, then a Python loop of batched decode steps.
Without ``paged_kv`` (the default, as in the JAX package) the rows share
one contiguous cache [L, B, Hkv, T, D], each decoding in place at its own
offset through the decode kernel (B2, or B3 over an int8 cache); with
``paged_kv=True`` the prompts' K/V are scattered into a page pool in
whole pages and attention merges the paged parts kernel's prompt term
with small side caches of the generated tokens (``models/transformer.py``'s
stacked-hybrid leaf). Each row's tokens equal the JAX engine's.

``decode_open`` opens a stepped decode session over either layout
(``engine/stepped.py``: joins in prefill chunks, cancel, stream deltas,
swap preemption, and on the contiguous layout recompute preemption; what
the continuous scheduler of ``serve/scheduler.py`` drives); with
``speculative=`` configured for the model, a session's slices are
draft-verify rounds whose verify forward runs the multi-query kernels
(``engine/speculative.py``): through the page table over the paged pool,
or over the contiguous rows of the batch cache (:func:`_contiguous_attention`).
A positive ``spec_accept_floor`` adapts a session's draft length to its
acceptance and falls it back to plain decode.
``generate_speculative`` serves one request that way (a greedy model
draft through the solo loop, anything else through a one-row session),
and ``generate`` routes eligible requests there.

Model residency follows the JAX engine's rules: ``load_model`` keeps the
models in LRU order, and before a load that would pass the device's
allocation budget (``utils/memory.py``: the card's total memory, or
``TPU_ALLOC_BUDGET_BYTES``) evicts the least recently used model's
weights; installed models and models with a live session are never
evicted. A load is refused with ``ModelMemoryError`` when it cannot fit
the budget (``TPU_MEMORY_BUDGET_BYTES`` overrides it).

The engine's paged dispatch (:func:`_paged_parts`) also serves the
write-through leaf ``{"pool", "table"}`` with the normalised paged kernel
(B6). As in the JAX package, that path is driven at the model level
(``write_prefill`` into a pool, then ``forward`` with the dispatch); the
engine has no entry point for it.

On a CUDA device attention always runs the hand-written kernels of
``ops/cuda_attention.py`` and ``ops/cuda_paged_attention.py``; their
wrappers, like the int4 matmul wrappers of ``ops/cuda_quant.py``, take
the plain versions only for tensors on the CPU, which is
where the tests run. The JAX engine's kernel policies (and its routing
between the Pallas parts kernel and an XLA gather) were measured on a TPU
and do not carry over.

Weights load at the engine's quantize mode for each model (None, int8,
int4 or int4-i32); at int4 every decode-shaped matmul (at most 8 rows)
runs an int4 kernel, and prefill and batches of more than 8 rows
dequantize and call ``torch.matmul``, as the JAX package does.

``generate_stream`` decodes the plain loop's state in chunks, so its
tokens are ``generate``'s. ``generate`` attaches the modelled energy of
each result as ``extras["energy_model"]`` (``obs/energy.py``), and so do
a batch (its window's Joules by token share) and a session (each slice's
by token share, closed out at retirement).

With ``prefix_cache_size`` or ``prefix_cache_bytes`` a solo prefill
seeds its cache from the longest cached prompt that prefixes it (a device
copy) and prefills only the rest, through B1 at that offset. Weights come
from random init, or from a local HF checkpoint (``hf_checkpoints``:
converted and quantized on the CPU, then moved to the device), and with
``weight_cache_dir`` from the on-disk weight cache (``engine/checkpoint.py``).

With ``prefix_share=True`` the engine owns a persistent cross-session
prefix store (``engine/radix_store.py``): stepped sessions publish every
prompt they prefill, and a joiner whose prompt shares a published prefix
maps its read-only pool pages (copy-on-write at a mid-page boundary) and
prefills only the divergent tail; a contiguous session reuses the seed
slab alone.

Not ported yet: CUDA graphs.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.config import MODEL_REGISTRY, ModelConfig, get_model_config
from ..models.quantize import QUANT_MODES, quantize_kv_cache, quantize_leaf, quantize_params
from ..models.tokenizer import load_tokenizer
from ..models.transformer import Transformer, forward, init_params, logits_for
from ..obs.metrics import REGISTRY as _OBS, enabled as _obs_enabled
from ..obs.trace import TRACER as _TRACER
from ..ops.cuda_attention import (
    cuda_decode_attention,
    cuda_decode_attention_int8,
    cuda_prefill_attention,
)
from ..ops.cuda_paged_attention import (
    cuda_contiguous_mq_attention,
    cuda_contiguous_mq_attention_int8,
    cuda_paged_decode_attention,
    cuda_paged_decode_attention_mq_parts,
    cuda_paged_decode_attention_mq_parts_int8,
    cuda_paged_decode_attention_parts,
    cuda_paged_decode_attention_parts_int8,
)
from ..ops.sampling import sample_token, sample_token_per_row
from .backend import GenerationBackend, GenerationChunk, GenerationRequest, GenerationResult
from .paged_kv import PagePool, _paginate, group_chunks, quantize_chunks, scatter_pages
from .radix_store import RadixPrefixStore
from .speculative import DraftSpec, build_spec_fn, build_spec_step_fn

PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
GEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
# Prompts longer than the largest bucket prefill in chunks of this size
# (the prefill kernel takes offset > 0 against a partially-filled cache).
PREFILL_CHUNK = PROMPT_BUCKETS[-1]
# A session joiner's prompt prefills in chunks of at most this many tokens
# (floored to a prompt bucket), one chunk between two decode slices, so
# the rows in flight stall for one chunk at a time (env
# PREFILL_CHUNK_TOKENS; the serve CLI's --prefill-chunk-tokens).
JOIN_PREFILL_CHUNK_TOKENS = int(os.environ.get("PREFILL_CHUNK_TOKENS", 0)) or 256
# A stop-string request checks its text every this many decode steps —
# the JAX engine's streamed chunk, so both exit within one chunk of a hit.
DEFAULT_STREAM_CHUNK = 32
# generate_batch rows pad up to these buckets.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# Budget for one sub-batch's K+V bytes: generate_batch picks the widest
# bucket whose estimated cache fits it, and the schedulers' admission cap
# (max_admission_rows) is that bucket. The value is the JAX package's
# default. Measured on an NVIDIA H100 80GB HBM3 (700 W limit) under
# chip_smoke.py's serve_continuous (qwen2:1.5b, int8 weights, bf16 pool):
# it admits 64 rows, while the continuous session held at most 4 live rows
# (its slots and pages are fixed at open) and the process peaked at
# 3.67 GB of 80 GB. The budget is not what binds there, so it stays.
BATCH_KV_BUDGET_BYTES = int(os.environ.get("BATCH_KV_BUDGET_BYTES", 2_500_000_000))
# Never split below this width whatever the estimate says (the JAX
# package's rule).
BATCH_MIN_SPLIT_ROWS = 32
# Stamped into every batch result's extras["decode_window"], so a consumer
# counts distinct decode windows (tokens/s = tokens over their summed time).
_DECODE_WINDOW_IDS = itertools.count()
# Decode steps (speculative sessions: draft-verify rounds) per session slice.
DECODE_SLICE_STEPS = int(os.environ.get("DECODE_SLICE_STEPS", 16))

_PREFILL_H = _OBS.histogram(
    "llm_engine_prefill_seconds",
    "Wall time of one prefill window (solo request or grouped rows)",
)
_DECODE_H = _OBS.histogram(
    "llm_engine_decode_seconds",
    "Wall time of one decode window (solo request or shared batch)",
)
_TOKENS_C = _OBS.counter(
    "llm_engine_generated_tokens_total",
    "Generated tokens, by attention path and KV representation",
    labels=("path", "kv"),
)
_STEPS_C = _OBS.counter(
    "llm_engine_decode_steps_total",
    "Decode-loop steps executed, by attention path and KV representation",
    labels=("path", "kv"),
)
_TOKS_PER_S_G = _OBS.gauge(
    "llm_engine_tokens_per_s",
    "Aggregate tokens/s of the most recent decode window",
    labels=("path", "kv"),
)


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def _floor_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Largest bucket <= n (the smallest when n undershoots them all): a
    chunk budget rounds down, so that it stays a cap."""
    best = buckets[0]
    for b in buckets:
        if b <= n:
            best = b
    return best


def _prompt_chunks(s_real: int, chunk: Optional[int] = None) -> "list[tuple[int, int]]":
    """Cover ``s_real`` prompt tokens as [(start, bucket), ...]: full
    ``chunk``-sized chunks (default PREFILL_CHUNK), then one
    bucket-rounded tail."""
    if chunk is None:
        chunk = PREFILL_CHUNK
    chunks = []
    start = 0
    while s_real - start > chunk:
        chunks.append((start, chunk))
        start += chunk
    chunks.append((start, _bucket(s_real - start, PROMPT_BUCKETS)))
    return chunks


def _prompt_alloc(s_real: int) -> int:
    """Cache slots the prompt needs (last chunk's end, bucket-rounded)."""
    start, bucket = _prompt_chunks(s_real)[-1]
    return start + bucket


def _apply_stop(tokens: "list[int]", text: str, tok, stop) -> "tuple[list[int], str]":
    """Cut output before the first occurrence of any stop string: text cut
    exactly; tokens cut at the smallest prefix whose decode covers the
    kept text (binary search, then a bounded linear fix-up for tokenizers
    whose decode is only approximately prefix-monotone)."""
    cuts = [text.find(s) for s in stop if s in text]
    if not cuts:
        return tokens, text
    kept = text[: min(cuts)]
    lo, hi = 0, len(tokens)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(tok.decode(tokens[:mid])) < len(kept):
            lo = mid + 1
        else:
            hi = mid
    for j in range(max(0, lo - 2), min(len(tokens), lo + 2) + 1):
        if len(tok.decode(tokens[:j])) >= len(kept):
            lo = j
            break
    return tokens[:lo], kept


def _spec_margin(k: int) -> int:
    """Extra cache slots a speculative request needs beyond its buckets
    (rounds overshoot by up to k; the draft seats one extra entry),
    rounded to 128 as the JAX package rounds it, so that its fit checks
    and cache sizes match."""
    return -(-(2 * k + 2) // 128) * 128


def _pow2_at_least(n: int, floor: int = 1) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


def _norm_spec(value) -> DraftSpec:
    """A ``speculative=`` value as a DraftSpec: ``("ngram", k)``,
    ``("cross:<model>", k)`` or ``(<draft model>, k)``."""
    if isinstance(value, DraftSpec):
        return value
    draft, k = value
    if draft == "ngram":
        return DraftSpec("ngram", None, int(k))
    if isinstance(draft, str) and draft.startswith("cross:"):
        return DraftSpec("cross", draft.split(":", 1)[1], int(k))
    return DraftSpec("model", draft, int(k))


def _resolve_device(device) -> torch.device:
    """``None`` means the card; without one that is an error, never a
    silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def _dir_signature(path: str) -> str:
    """A checkpoint directory's content signature: the latest mtime_ns
    and the total bytes of its files."""
    latest, total = 0, 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                st = os.stat(os.path.join(root, f))
            except OSError:
                continue
            latest = max(latest, st.st_mtime_ns)
            total += st.st_size
    return f"{latest}:{total}"


def _params_to(params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Every leaf (quantized dicts included) on ``device``."""
    return {
        name: {k: t.to(device) for k, t in leaf.items()} if isinstance(leaf, dict) else leaf.to(device)
        for name, leaf in params.items()
    }


def _int8_cache_attention(q, k_cache, v_cache, lengths):
    return cuda_decode_attention_int8(
        q, k_cache["q"], k_cache["s"], v_cache["q"], v_cache["s"], lengths
    )


def _contiguous_attention(q, k_cache, v_cache, lengths):
    """The engine's attention callable over a contiguous batch cache with
    per-row positions: one query a row (``q [B, Hq, D]``) goes to B2/B3; a
    speculative verify block ``q [B, k+1, Hq, D]``, whose candidates the
    transformer has written at ``offset..offset+k``, to the multi-query
    kernels over contiguous rows, query 0 at ``lengths - (k+1)``."""
    if q.dim() == 3:
        if isinstance(k_cache, dict):
            return _int8_cache_attention(q, k_cache, v_cache, lengths)
        return cuda_decode_attention(q, k_cache, v_cache, lengths)
    offsets = lengths - q.shape[1]
    if isinstance(k_cache, dict):
        return cuda_contiguous_mq_attention_int8(
            q, k_cache["q"], k_cache["s"], v_cache["q"], v_cache["s"], lengths, offsets
        )
    return cuda_contiguous_mq_attention(q, k_cache, v_cache, lengths, offsets)


def _paged_parts(q, k_leaf, v_leaf, lengths):
    """The engine's paged attention callable (the JAX engine's
    ``_paged_decode_attention`` dispatch). On a stacked-hybrid leaf: the
    prompt-pages term, unnormalised (acc, m, l) from the parts kernel of
    the pool's kind; a speculative verify block ``q [B, k+1, Hq, D]`` goes
    to the multi-query kernel, with query 0 at ``write_pos + prompt_lens``
    (every candidate sits past the prompt, so its causal cut hides no
    cached token). On a write-through leaf ``{"pool", "table"}``: the
    normalised attention of B6, over a bf16/f32 pool only."""
    if "side" not in k_leaf:
        if isinstance(k_leaf["pool"], dict):
            raise NotImplementedError(
                "an int8 write-through pool has no paged decode kernel (the JAX "
                "package has no int8 twin of pallas_paged_decode_attention); "
                "decode it with decode_attention=None, the gather path"
            )
        return cuda_paged_decode_attention(
            q, k_leaf["pool"], v_leaf["pool"], k_leaf["table"], lengths
        )
    if q.dim() == 4:
        offsets = (k_leaf["write_pos"] + k_leaf["prompt_lens"]).to(torch.int32)
        if isinstance(k_leaf["pool"], dict):
            return cuda_paged_decode_attention_mq_parts_int8(
                q, k_leaf["pool"]["q"], k_leaf["pool"]["s"],
                v_leaf["pool"]["q"], v_leaf["pool"]["s"], k_leaf["table"], lengths, offsets,
            )
        return cuda_paged_decode_attention_mq_parts(
            q, k_leaf["pool"], v_leaf["pool"], k_leaf["table"], lengths, offsets
        )
    if isinstance(k_leaf["pool"], dict):
        return cuda_paged_decode_attention_parts_int8(
            q, k_leaf["pool"]["q"], k_leaf["pool"]["s"],
            v_leaf["pool"]["q"], v_leaf["pool"]["s"], k_leaf["table"], lengths,
        )
    return cuda_paged_decode_attention_parts(
        q, k_leaf["pool"], v_leaf["pool"], k_leaf["table"], lengths
    )


class TorchEngine(GenerationBackend):
    """In-process generation over the model registry on one device.

    ``registry`` maps model name → ModelConfig (pass tiny() configs for
    tests). ``quantize`` is the weights' mode: None, "int8", "int4" or
    "int4-i32" for every model, or a per-model dict ``{model: mode}`` with
    an optional ``"default"`` key (small models at int8, large ones at
    int4, from one engine); ``kv_quantize`` is None or "int8" (the decode loop's cache,
    and the page pool's under ``paged_kv``). ``paged_kv=True`` makes
    ``generate_batch`` and sessions decode over a page pool of
    ``page_size`` tokens a page instead of one contiguous batch cache;
    ``generate`` stays the solo contiguous path.

    ``speculative`` maps a target model (or ``"default"``) to its draft:
    ``(draft_model, k)``, ``("ngram", k)`` or ``("cross:<model>", k)``,
    as the JAX engine takes it. ``spec_temperature_max`` caps the
    temperature of requests that speculate, ``spec_draft_temperature``
    sets the proposal temperature of sampled rows' model drafts, and
    ``spec_accept_floor`` (in [0, 1)) turns on a session's adaptive draft
    length and fallback to plain decode (``engine/stepped.py``);
    ``spec_draft_jpt`` is the fleet's hook that prices a cross-model
    draft's wasted tokens.

    ``prefix_cache_size`` (entries per model) and ``prefix_cache_bytes``
    (bytes over every model) cap the solo prompt-prefix KV cache; either
    one turns it on. ``hf_checkpoints`` maps a model to a local HF
    checkpoint directory to load its weights and tokenizer from;
    ``weight_cache_dir`` keeps each model's built params on disk, keyed by
    config, dtype, source and quant mode. ``prefix_share`` builds the
    engine's shared prefix store (``engine/radix_store.py``), capped at
    ``prefix_index_entries`` nodes a model and by the byte budgets
    ``prefix_store_hbm_bytes`` (device pages; over it, cold nodes spill to
    host memory) and ``prefix_store_host_bytes`` (spilled pages and seed
    slabs; over it, cold leaves are evicted); ``prefix_store_scope``
    ``"session"`` drops a model's tree when its session closes.
    """

    def __init__(
        self,
        registry: Optional[Dict[str, ModelConfig]] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        quantize: "str | Dict[str, Optional[str]] | None" = None,
        kv_quantize: Optional[str] = None,
        device=None,
        *,
        paged_kv: bool = False,
        page_size: int = 128,
        speculative=None,
        spec_accept_floor: float = 0.0,
        spec_temperature_max: float = 2.0,
        spec_draft_temperature: Optional[float] = None,
        prefix_cache_size: int = 0,
        prefix_cache_bytes: Optional[int] = None,
        prefix_share: bool = False,
        prefix_index_entries: int = 16,
        prefix_store_hbm_bytes: Optional[int] = None,
        prefix_store_host_bytes: Optional[int] = None,
        prefix_store_scope: str = "engine",
        hf_checkpoints: Optional[Dict[str, str]] = None,
        weight_cache_dir=None,
    ) -> None:
        if not 0.0 <= float(spec_accept_floor) < 1.0:
            raise ValueError(f"spec_accept_floor must be in [0, 1), got {spec_accept_floor}")
        if prefix_cache_size < 0:
            raise ValueError(f"prefix_cache_size must be >= 0, got {prefix_cache_size}")
        if prefix_cache_bytes is not None and prefix_cache_bytes < 0:
            raise ValueError(f"prefix_cache_bytes must be >= 0, got {prefix_cache_bytes}")
        valid_modes = (None, *QUANT_MODES)
        if isinstance(quantize, dict):
            for name, mode in quantize.items():
                if mode not in valid_modes:
                    raise ValueError(f"unsupported quantize mode for {name!r}: {mode!r}")
        elif quantize not in valid_modes:
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        if kv_quantize not in (None, "int8"):
            raise ValueError(f"unsupported kv_quantize mode: {kv_quantize!r}")
        # The JAX package's rule (its TPU kernels tile pages on 128 lanes),
        # kept so that admission arithmetic and page counts match it.
        if page_size < 1 or page_size % 128:
            raise ValueError(
                f"page_size must be a positive multiple of 128, got {page_size}"
            )
        if float(spec_temperature_max) < 0.0:
            raise ValueError(f"spec_temperature_max must be >= 0, got {spec_temperature_max}")
        if spec_draft_temperature is not None and not float(spec_draft_temperature) > 0.0:
            raise ValueError(
                f"spec_draft_temperature must be > 0 when set, got {spec_draft_temperature}"
            )
        self.speculative = {name: _norm_spec(v) for name, v in (speculative or {}).items()}
        self.spec_accept_floor = float(spec_accept_floor)
        # recent fallback acceptances per draft source ("source:draft"):
        # sessions append on fallback and clear on a healthy close, and
        # _init_spec skips arming a source whose window sits under the floor
        self._spec_source_health: Dict[str, list] = {}
        # the fleet's hook: a draft model's live J/token, which prices the
        # tokens of a cross-model draft's fully rejected rounds
        self.spec_draft_jpt: Optional[Callable[[str], Optional[float]]] = None
        self.spec_temperature_max = float(spec_temperature_max)
        self.spec_draft_temperature = (
            None if spec_draft_temperature is None else float(spec_draft_temperature)
        )
        self.paged_kv = bool(paged_kv)
        self.page_size = page_size
        # The shared prefix store: engine-owned, so it outlives every
        # stepped session (a joiner in a fresh session still hits what an
        # earlier one published). Page sharing engages on the paged pool,
        # seed-only reuse on the contiguous cache.
        self.prefix_share = bool(prefix_share)
        if prefix_index_entries < 1:
            raise ValueError(f"prefix_index_entries must be >= 1, got {prefix_index_entries}")
        self.prefix_index_entries = int(prefix_index_entries)
        for knob, value in (
            ("prefix_store_hbm_bytes", prefix_store_hbm_bytes),
            ("prefix_store_host_bytes", prefix_store_host_bytes),
        ):
            if value is not None and int(value) < 0:
                raise ValueError(f"{knob} must be >= 0, got {value}")
        self.prefix_store: Optional[RadixPrefixStore] = None
        if self.prefix_share:
            self.prefix_store = RadixPrefixStore(
                capacity=self.prefix_index_entries,
                hbm_bytes=prefix_store_hbm_bytes,
                host_bytes=prefix_store_host_bytes,
                scope=prefix_store_scope,
            )
        self.device = _resolve_device(device)
        if self.device.type == "cuda":
            # Full-precision float32 products in the plain code around the
            # kernels; the kernels never use TF32 either.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.registry = dict(registry) if registry is not None else dict(MODEL_REGISTRY)
        self.dtype = dtype
        self.seed = seed
        self.quantize = quantize
        self.kv_quantize = kv_quantize
        # model name -> local HF checkpoint directory: load_model converts
        # its weights (models/convert.py) instead of drawing random ones,
        # and the model tokenizes with the checkpoint's tokenizer
        self.hf_checkpoints = dict(hf_checkpoints or {})
        # the on-disk weight cache: a load restores the params it wrote
        # under the same fingerprint instead of building them again
        self._weight_cache = None
        if weight_cache_dir:
            from .checkpoint import WeightCache

            self._weight_cache = WeightCache(weight_cache_dir)
        # The solo prompt-prefix KV cache (off by default: the energy study
        # wants every run to pay its own prefill): model -> OrderedDict LRU
        # of ids-tuple -> (k, v, last-position logits, lru stamp). Either
        # cap enables it: entries per model, or bytes over every model.
        self.prefix_cache_size = prefix_cache_size
        self.prefix_cache_bytes = prefix_cache_bytes
        self._prefix_enabled = prefix_cache_size > 0 or prefix_cache_bytes is not None
        self._prefix_cache: Dict[str, "OrderedDict[tuple, tuple]"] = {}
        self._prefix_clock = 0  # global LRU stamp across models
        self._prefix_hits = 0  # prefills seeded from a cached prefix
        # resident models in LRU order (load_model moves a used one to the
        # end; the eviction pass takes from the front)
        self._models: Dict[str, Transformer] = {}
        # installed weights have no source to reload from: never evicted
        self._pinned: set = set()
        # open stepped sessions per model: eviction defers while > 0
        self._live_sessions: Dict[str, int] = {}
        self._tokenizers: Dict[str, Any] = {}
        self._warmed: set = set()
        # speculative step functions, by (model, draft, k, slice, source,
        # top_k, use_top_p)
        self._decode_cache: Dict[tuple, Callable] = {}
        # the live modelled J/token of the most recent attributed result
        # (overall and by model), refreshed by every attribution path
        self.last_joules_per_token: Optional[float] = None
        self.last_joules_per_token_by_model: Dict[str, float] = {}

    # -- model management -----------------------------------------------------
    def _quant_mode(self, model: str) -> Optional[str]:
        """The weight-quantization mode for ``model`` (see the class)."""
        if isinstance(self.quantize, dict):
            return self.quantize.get(model, self.quantize.get("default"))
        return self.quantize

    def load_model(self, model: str) -> None:
        if model in self._models:
            # refresh LRU recency (dicts keep insertion order; the
            # eviction pass takes from the front)
            self._models[model] = self._models.pop(model)
            return
        cfg = self.registry[model] if model in self.registry else get_model_config(model)
        # eviction first: the resident-sum check would otherwise refuse
        # loads that evicting the least recently used models makes fit
        self._ensure_allocation_capacity(model, cfg)
        self._check_memory_budget(model, cfg)
        t0 = time.monotonic()
        mode = self._quant_mode(model)
        post = None
        if mode is not None:
            post = lambda name, leaf: quantize_leaf(name, leaf, mode)  # noqa: E731
        ckpt_dir = self.hf_checkpoints.get(model)
        if ckpt_dir is not None:

            def make_params():
                # Convert on the CPU leaf by leaf (each cast straight to
                # the engine's dtype), quantize there, then move only the
                # result to the device.
                from ..models.convert import load_hf_pretrained

                return _params_to(load_hf_pretrained(ckpt_dir, cfg, dtype=self.dtype, post=post), self.device)

        else:

            def make_params():
                gen = torch.Generator(device=self.device).manual_seed(self.seed)
                return init_params(cfg, gen, self.dtype, post=post)

        if self._weight_cache is not None:
            import hashlib

            # The fingerprint keys the stored params to this architecture,
            # dtype, weight source and quant mode: a tiny() config, another
            # dtype or another checkpoint directory must miss. A checkpoint
            # source also carries its content signature, so an in-place
            # re-download at the same path misses too.
            source = (
                f"hf:{ckpt_dir}|{_dir_signature(ckpt_dir)}" if ckpt_dir is not None else "init"
            )
            fingerprint = hashlib.sha256(
                f"{cfg!r}|{str(self.dtype).removeprefix('torch.')}|{source}|quant:{mode}".encode()
            ).hexdigest()[:12]
            params = self._weight_cache.get_or_init(
                model, self.seed, make_params, fingerprint=fingerprint, device=self.device
            )
        else:
            params = make_params()
        self._sync()
        self._models[model] = Transformer(cfg=cfg, params=params)
        self._observe_model_loaded(model, load_s=time.monotonic() - t0)

    def install_model(self, model: str, cfg: ModelConfig, params: Dict[str, Any]) -> None:
        """Serve externally produced weights (e.g. the JAX package's,
        through ``models.bridge``) under ``model``, applying the engine's
        quantization mode. Re-installing a name drops everything derived
        from the old weights and config (step functions, warm markers,
        the tokenizer). Installed weights are pinned: the LRU guard never
        evicts them, since nothing could reload them."""
        self._evict_model_state(model)
        self._ensure_allocation_capacity(model, cfg)
        self._check_memory_budget(model, cfg)
        mode = self._quant_mode(model)
        if mode is not None:
            params = quantize_params(params, mode=mode)
        self.registry[model] = cfg
        self._models[model] = Transformer(cfg=cfg, params=params)
        self._pinned.add(model)
        self._observe_model_loaded(model)

    # -- model residency: the LRU guard ------------------------------------------
    def _weight_bytes(self, model: str, cfg: ModelConfig) -> int:
        from ..utils.memory import estimate_weight_bytes

        return estimate_weight_bytes(cfg, self._quant_mode(model), self._itemsize())

    def _check_memory_budget(self, model: str, cfg: ModelConfig) -> None:
        """Fail fast, with the estimated bytes, the budget and the remedy,
        instead of a CUDA out-of-memory error inside a load. The budget
        is ``utils/memory.device_memory_budget`` (the card's total, or
        ``TPU_MEMORY_BUDGET_BYTES``); resident models count against it.
        No budget (the CPU) skips the check."""
        from ..utils.memory import ModelMemoryError, device_memory_budget

        budget = device_memory_budget(self.device)
        if budget is None:
            return
        mode = self._quant_mode(model)
        est = self._weight_bytes(model, cfg)
        resident = (
            0 if budget.per_program
            else sum(self._weight_bytes(name, tf.cfg) for name, tf in self._models.items())
        )
        if est + resident > budget.bytes:
            if mode is None:
                hint = "quantize (int8 halves, int4 quarters the bytes)"
            elif mode == "int8":
                hint = "quantize to int4"
            else:
                hint = "use a card with more memory"
            if resident:
                hint += (
                    f"; or unload_all() first ({len(self._models)} models, "
                    f"~{resident / 1024**3:.2f} GiB, already resident)"
                )
            raise ModelMemoryError(model, est + resident, budget.bytes, hint)

    def _ensure_allocation_capacity(self, model: str, cfg: ModelConfig) -> None:
        """The LRU model guard: before a load that would overflow the
        device's allocation budget (``utils/memory.device_allocation_budget``),
        evict the least recently used models' weights. Step functions,
        warm markers and tokenizers stay: they hold configs, not weights,
        so a reload serves them as they are. The budget counts the byte
        model's resident estimates plus the load's transient headroom,
        never the allocator's free bytes (freed blocks stay reserved in
        PyTorch's caching allocator). Cached prompt prefixes are device
        memory too and count against it; they go first, being only
        recompute. Installed models are never victims;
        a model with a live stepped session is not either: its eviction
        defers until the session closes."""
        from ..runner import term
        from ..utils import memory

        budget = memory.device_allocation_budget(self.device)
        if budget is None or not self._models:
            return
        incoming = self._weight_bytes(model, cfg) + memory.LOAD_TRANSIENT_HEADROOM_BYTES
        resident = {name: self._weight_bytes(name, tf.cfg) for name, tf in self._models.items()}
        prefix_resident = self._prefix_bytes()
        while sum(resident.values()) + prefix_resident + incoming > budget:
            if prefix_resident > 0:
                freed = self._evict_prefix_lru()
                if freed:
                    prefix_resident -= freed
                    term.log(
                        f"evicted a cached prompt prefix (~{freed / 1024**2:.1f} MiB) to fit {model}"
                    )
                    continue
                prefix_resident = 0
            victim = next(
                (n for n in self._models
                 if n not in self._pinned and not self._live_sessions.get(n)),
                None,
            )
            if victim is None:
                live = [n for n in self._models
                        if n not in self._pinned and self._live_sessions.get(n)]
                if live:
                    from ..obs.metrics import MODEL_EVICT_DEFERRED_C

                    if _obs_enabled():
                        MODEL_EVICT_DEFERRED_C.inc()
                    term.log(
                        f"deferring weight eviction for {model}: "
                        f"{', '.join(live)} hold(s) live stepped rows"
                    )
                break
            freed = resident.pop(victim)
            self._evict_weights(victim)
            term.log(
                f"evicted {victim} weights (~{freed / 1024**3:.2f} GiB) to fit "
                f"{model}; step functions kept, reload is cheap"
            )

    def _evict_weights(self, model: str, reason: str = "lru") -> None:
        """Drop a model's weights, and with them its device memory: the
        engine holds its only reference (no step function, warm marker or
        closed session keeps ``params``), and its cached prompt prefixes.
        Step functions, warm markers and the tokenizer stay."""
        evicted = self._models.pop(model, None) is not None
        self._prefix_cache.pop(model, None)
        if evicted:
            self._observe_model_evicted(model, reason)

    def _evict_model_state(self, model: str) -> None:
        """Drop every per-model derivative: step functions (their closures
        hold the old config), cached prompt prefixes (computed from the old
        weights), warm markers, the tokenizer, the pin and the model
        itself (keys are tuples naming the model)."""
        evicted = self._models.pop(model, None) is not None
        self._pinned.discard(model)
        self._tokenizers.pop(model, None)
        self._prefix_cache.pop(model, None)
        for key in [k for k in self._decode_cache if model in k]:
            del self._decode_cache[key]
        self._warmed = {k for k in self._warmed if model not in k}
        if evicted:
            self._observe_model_evicted(model, "reinstall")

    def model_weight_bytes(self, model: str) -> int:
        """Estimated resident weight bytes of ``model`` under this
        engine's quantization rules, loaded or not (the byte model of
        ``utils/memory.py``)."""
        if model in self._models:
            cfg = self._models[model].cfg
        elif model in self.registry:
            cfg = self.registry[model]
        else:
            cfg = get_model_config(model)
        return self._weight_bytes(model, cfg)

    def _observe_model_loaded(self, model: str, load_s: Optional[float] = None) -> None:
        """Residency gauges and the ``model_loaded`` flight event, linked
        to the request that caused the load when one is current.
        Telemetry never fails a load."""
        if not _obs_enabled():
            return
        try:
            from ..obs.flight import EV_MODEL_LOADED, FLIGHT, trace_attrs
            from ..obs.metrics import observe_model_loaded

            nbytes = self.model_weight_bytes(model)
            observe_model_loaded(model, nbytes)
            FLIGHT.emit(
                EV_MODEL_LOADED, model=model, weight_bytes=nbytes,
                **({"load_s": round(load_s, 4)} if load_s is not None else {}),
                **trace_attrs(_TRACER.current()),
            )
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _observe_model_evicted(self, model: str, reason: str) -> None:
        if not _obs_enabled():
            return
        try:
            from ..obs.flight import EV_MODEL_EVICTED, FLIGHT, trace_attrs
            from ..obs.metrics import observe_model_evicted

            observe_model_evicted(model, reason)
            FLIGHT.emit(
                EV_MODEL_EVICTED, model=model, reason=reason,
                **trace_attrs(_TRACER.current()),
            )
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _session_opened(self, model: str) -> None:
        """A stepped session holds live rows of ``model``: keep its
        weights out of the LRU guard's reach until :meth:`_session_closed`."""
        self._live_sessions[model] = self._live_sessions.get(model, 0) + 1

    def _session_closed(self, model: str) -> None:
        n = self._live_sessions.get(model, 0) - 1
        if n > 0:
            self._live_sessions[model] = n
        else:
            self._live_sessions.pop(model, None)

    def live_sessions(self, model: str) -> int:
        """Open stepped sessions holding rows of ``model`` (0: eviction
        is allowed)."""
        return self._live_sessions.get(model, 0)

    def models_debug_state(self) -> Dict[str, Any]:
        """The residency block of ``GET /debug/state``: resident models
        with their estimated bytes, live-session counts and last modelled
        J/token, and the pinned ones."""
        out: Dict[str, Any] = {"loaded": {}, "pinned": sorted(self._pinned)}
        if self._prefix_enabled:
            out["prefix_cache"] = self.prefix_cache_state()
        for name in self.loaded_models():
            try:
                nbytes = self.model_weight_bytes(name)
            except Exception:  # noqa: BLE001 — estimate only
                nbytes = None
            out["loaded"][name] = {
                "weight_bytes": nbytes,
                "live_sessions": self._live_sessions.get(name, 0),
                "joules_per_token": self.last_joules_per_token_by_model.get(name),
            }
        return out

    def loaded_models(self) -> List[str]:
        # dict.copy() is atomic under the GIL: a snapshot even while
        # another thread loads a model
        return sorted(self._models.copy())

    def unload_all(self) -> None:
        for model in list(self._models):
            self._observe_model_evicted(model, "unload")
        self._decode_cache.clear()
        self._models.clear()
        self._pinned.clear()
        self._tokenizers.clear()
        self._prefix_cache.clear()
        self._warmed.clear()

    def _tokenizer_for(self, model: str):
        """The checkpoint's own tokenizer for a model served from a local
        HF checkpoint (its ids index the trained embeddings); the byte
        tokenizer otherwise, or when the checkpoint's does not load."""
        if model not in self._tokenizers:
            self._tokenizers[model] = load_tokenizer(self.hf_checkpoints.get(model))
        return self._tokenizers[model]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bind_thread(self) -> None:
        """Make this engine's card the calling thread's current device: a
        scheduler thread calls it before it launches anything, so that
        every launch lands on the card's one stream."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index if self.device.index is not None else 0)

    def warmup(self, request: GenerationRequest) -> None:
        """Load the weights, build the kernels and bring PyTorch's caches
        to steady state for this request's shape, outside any measured
        window."""
        key = (
            request.model,
            _prompt_alloc(len(self._tokenizer_for(request.model).encode(request.prompt))),
            _bucket(request.max_new_tokens, GEN_BUCKETS),
        )
        if key in self._warmed:
            return
        self.generate(request)
        self._warmed.add(key)

    # -- generation -----------------------------------------------------------
    def _run_prefill(self, model: str, prompt_ids: "list[int]", cache_len: int):
        """Build the KV cache and prefill the prompt chunk by chunk; returns
        the last prompt position's logits and the caches.

        With the prefix cache on, the longest cached prompt that is an
        exact prefix of this one is copied into the fresh cache and only
        the rest is prefilled, from that position on (the system-prompt
        win); the prompt's own K/V are then cached in turn."""
        tf = self._models[model]
        pad = self._tokenizer_for(model).pad_id
        s_real = len(prompt_ids)
        k_cache, v_cache = tf.init_cache(1, cache_len, dtype=self.dtype)
        logits = None
        covered = 0
        hit = self._find_prefix(model, prompt_ids)
        if hit is not None:
            hit_ids, hit_k, hit_v, hit_logits = hit
            p = len(hit_ids)
            # The rest re-chunks from p, and the tail chunk's bucket must
            # end inside cache_len: use less of the hit where it would not.
            while 0 < p < s_real and p + _prompt_alloc(s_real - p) > cache_len:
                p -= 1
            if p > 0:
                # a copy into this request's cache: the entry stays intact
                k_cache[:, :, :, :p].copy_(hit_k[:, :, :, :p])
                v_cache[:, :, :, :p].copy_(hit_v[:, :, :, :p])
                covered = p
                logits = hit_logits  # read only when the hit covers the prompt
                self._prefix_hits += 1
        if covered < s_real:
            remaining = prompt_ids[covered:]
            for start, bucket in _prompt_chunks(len(remaining)):
                ids = remaining[start : start + bucket]
                real = len(ids)
                tokens = torch.tensor(
                    [ids + [pad] * (bucket - real)], dtype=torch.long, device=self.device
                )
                hidden, k_cache, v_cache = forward(
                    tf.params, tf.cfg, tokens, covered + start, k_cache, v_cache,
                    None, cuda_prefill_attention, layers=tf.layers,
                )
            logits = logits_for(tf.params, tf.cfg, hidden[:, real - 1])
        self._store_prefix(model, prompt_ids, k_cache, v_cache, logits, s_real)
        return logits, k_cache, v_cache

    # -- the prompt-prefix cache ------------------------------------------------
    def _find_prefix(self, model: str, prompt_ids: "list[int]"):
        """The longest cached (ids, k, v, logits) whose ids are a prefix
        of ``prompt_ids``; refreshes its LRU position."""
        if not self._prefix_enabled:
            return None
        entries = self._prefix_cache.get(model)
        if not entries:
            return None
        best_key = None
        n = len(prompt_ids)
        for key in entries:
            if len(key) <= n and list(key) == prompt_ids[: len(key)]:
                if best_key is None or len(key) > len(best_key):
                    best_key = key
        if best_key is None:
            return None
        entries.move_to_end(best_key)
        k, v, logits, _ = entries[best_key]
        self._prefix_clock += 1
        entries[best_key] = (k, v, logits, self._prefix_clock)
        return list(best_key), k, v, logits

    @staticmethod
    def _prefix_entry_bytes(entry) -> int:
        k, v, logits, _stamp = entry
        return sum(t.numel() * t.element_size() for t in (k, v) + ((logits,) if logits is not None else ()))

    def _prefix_bytes(self) -> int:
        """Device bytes held by cached prompt K/V, over every model."""
        return sum(
            self._prefix_entry_bytes(e) for entries in self._prefix_cache.values() for e in entries.values()
        )

    def _evict_prefix_lru(self) -> int:
        """Drop the least recently used prefix entry of any model; returns
        the bytes freed (0 when the cache is empty)."""
        best = None
        for model, entries in self._prefix_cache.items():
            for key, entry in entries.items():
                if best is None or entry[3] < best[0]:
                    best = (entry[3], model, key)
        if best is None:
            return 0
        _, model, key = best
        freed = self._prefix_entry_bytes(self._prefix_cache[model].pop(key))
        if not self._prefix_cache[model]:
            del self._prefix_cache[model]
        return freed

    def _store_prefix(self, model, prompt_ids, k_cache, v_cache, logits, s_real) -> None:
        if not self._prefix_enabled:
            return
        entries = self._prefix_cache.setdefault(model, OrderedDict())
        # Only the prompt's own positions, and as a copy: the caches are
        # written in place by the decode that follows, and a view would
        # hold the whole allocation (and its bf16 original after an int8
        # conversion) while the budget counted only the prompt.
        self._prefix_clock += 1
        entries[tuple(prompt_ids)] = (
            k_cache[:, :, :, :s_real].clone(),
            v_cache[:, :, :, :s_real].clone(),
            logits,
            self._prefix_clock,
        )
        entries.move_to_end(tuple(prompt_ids))
        while self.prefix_cache_size and len(entries) > self.prefix_cache_size:
            entries.popitem(last=False)
        # The byte cap holds over every model's entries: evict the least
        # recently used until under it; an entry larger than the cap alone
        # goes too.
        if self.prefix_cache_bytes is not None:
            while self._prefix_bytes() > self.prefix_cache_bytes and self._evict_prefix_lru():
                pass

    def prefix_cache_state(self) -> Dict[str, Any]:
        """The prefix cache as ``GET /debug/state`` shows it: entries per
        model, the bytes held, and the prefills a cached prefix seeded."""
        return {
            "entries": {model: len(entries) for model, entries in self._prefix_cache.items()},
            "bytes": self._prefix_bytes(),
            "hits": self._prefix_hits,
        }

    def _start(
        self,
        request: GenerationRequest,
        cache_len: Optional[int] = None,
        prompt_ids: "Optional[list[int]]" = None,
    ) -> Dict[str, Any]:
        """Tokenize, bucket, prefill and sample the first token.
        ``cache_len`` overrides the cache size (the batch path sizes it to
        the prompt); ``prompt_ids`` skips re-tokenizing."""
        self.load_model(request.model)
        tf = self._models[request.model]
        cfg = tf.cfg
        tok = self._tokenizer_for(request.model)
        if prompt_ids is None:
            prompt_ids = tok.encode(request.prompt)
        if not prompt_ids:
            raise ValueError(
                f"{request.model}: prompt encodes to zero tokens (empty "
                "prompt and the tokenizer adds no BOS); provide a non-empty prompt"
            )
        s_real = len(prompt_ids)
        s_bucket = _prompt_alloc(s_real)
        g_bucket = _bucket(request.max_new_tokens, GEN_BUCKETS)
        if cache_len is None:
            cache_len = s_bucket + g_bucket
        if cache_len > cfg.max_seq_len:
            raise ValueError(
                f"{request.model}: prompt bucket {s_bucket} + generation "
                f"bucket {g_bucket} exceeds max_seq_len {cfg.max_seq_len}; "
                "shorten the prompt or max_new_tokens"
            )
        use_top_p = request.top_p < 1.0
        use_rp = request.repeat_penalty != 1.0
        presence = None
        if use_rp:
            presence = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=self.device)
            presence[0, torch.tensor(prompt_ids, device=self.device)] = True
        gen = torch.Generator(device=self.device).manual_seed(request.seed)

        t0 = time.monotonic()
        logits, k_cache, v_cache = self._run_prefill(request.model, prompt_ids, cache_len)
        first = sample_token(
            logits, gen, request.temperature, request.top_k,
            request.top_p if use_top_p else None,
            presence, request.repeat_penalty if use_rp else None,
        )
        if use_rp:
            presence[0, first] = True
        first_id = int(first[0])  # host read: also fences the prefill
        self._sync()
        t1 = time.monotonic()
        if _obs_enabled():
            _PREFILL_H.observe(t1 - t0)
            _TRACER.add_span(
                "prefill", t0, t1,
                attrs={"model": request.model, "prompt_tokens": s_real},
            )
        return {
            "tf": tf, "tok": tok, "s_real": s_real, "g_bucket": g_bucket,
            "first": first, "first_id": first_id, "gen": gen,
            "k_cache": k_cache, "v_cache": v_cache, "presence": presence,
            "use_top_p": use_top_p, "use_rp": use_rp, "t0": t0, "t1": t1,
        }

    def generate(self, request: GenerationRequest) -> GenerationResult:
        """One request. With a speculative config for its model, an
        eligible request without stop strings goes to
        :meth:`generate_speculative` (greedy rows give plain decode's
        tokens, sampled rows its distribution), unless the speculative
        cache margin would pass ``max_seq_len``; then, and otherwise, the
        plain contiguous decode loop serves it."""
        spec = None if request.stop else self._resolve_spec(request.model)
        if spec is not None and self._spec_eligible(request):
            self.load_model(request.model)
            cfg = self._models[request.model].cfg
            ids = self._tokenizer_for(request.model).encode(request.prompt)
            s_b = _prompt_alloc(len(ids))
            g_b = _bucket(request.max_new_tokens, GEN_BUCKETS)
            if s_b + g_b + _spec_margin(spec.k) <= cfg.max_seq_len:
                return self.generate_speculative(
                    request, spec.draft, spec.k, prompt_ids=ids, source=spec.source
                )
            return self._generate_plain(request, prompt_ids=ids)
        return self._generate_plain(request)

    def _generate_plain(
        self, request: GenerationRequest, prompt_ids: "Optional[list[int]]" = None
    ) -> GenerationResult:
        """The plain decode loop over the contiguous cache."""
        st = self._start(request, prompt_ids=prompt_ids)
        tok = st["tok"]
        eos = tok.eos_id
        generated = [st["first_id"]]
        # With stop strings the host checks the text every chunk and ends
        # the loop after the chunk that hit, as the JAX engine's streamed
        # decode does; an EOS first token then ends it before decoding.
        chunk = _bucket(min(DEFAULT_STREAM_CHUNK, request.max_new_tokens), GEN_BUCKETS)
        stopped = bool(request.stop) and (
            (request.stop_at_eos and generated[0] == eos)
            or any(s in tok.decode(generated) for s in request.stop)
        )
        remaining = request.max_new_tokens - 1  # the first token is already sampled
        while remaining > 0 and not stopped:
            ids = self._decode_plain(request, st, min(chunk, remaining) if request.stop else remaining)
            generated.extend(ids)
            remaining -= len(ids)
            if ids[-1] == eos:
                break
            if request.stop:
                text = tok.decode(generated)
                stopped = any(s in text for s in request.stop)
        self._sync()
        t2 = time.monotonic()
        return self._finish(request, generated, st, t2)

    def _decode_plain(self, request: GenerationRequest, st: Dict[str, Any], n: int) -> "list[int]":
        """Up to ``n`` decode steps continuing ``st`` (the caches, the last
        token and its offset, the generator and presence mask); stops
        after an EOS. On the first call an int8-KV engine quantizes the
        prefilled cache (prefill always runs on the bf16 cache). Returns
        the new token ids."""
        if "attention" not in st:
            if self.kv_quantize:
                st["k_cache"], st["v_cache"] = quantize_kv_cache(st["k_cache"], st["v_cache"])
            st["attention"] = self._decode_attention_for_cache()
            st["token"] = st["first"].reshape(1, 1)
            st["offset"] = st["s_real"]
        tf = st["tf"]
        eos = st["tok"].eos_id
        top_p = request.top_p if st["use_top_p"] else None
        rp = request.repeat_penalty if st["use_rp"] else None
        out: "list[int]" = []
        for _ in range(n):
            hidden, _, _ = forward(
                tf.params, tf.cfg, st["token"], st["offset"], st["k_cache"], st["v_cache"],
                st["attention"], layers=tf.layers,
            )
            logits = logits_for(tf.params, tf.cfg, hidden[:, 0])
            nxt = sample_token(
                logits, st["gen"], request.temperature, request.top_k,
                top_p, st["presence"], rp,
            )
            if st["use_rp"]:
                st["presence"][0, nxt] = True
            nxt_id = int(nxt[0])
            out.append(nxt_id)
            st["token"] = nxt.reshape(1, 1)
            st["offset"] += 1
            if nxt_id == eos:
                break
        return out

    def generate_stream(self, request: GenerationRequest, chunk_tokens: int = DEFAULT_STREAM_CHUNK):
        """Incremental generation: decode in chunks of ``chunk_tokens``
        steps over the plain loop's state, yielding a ``GenerationChunk``
        after each, so the token stream is the one :meth:`generate`'s
        plain loop makes; the final ``done`` chunk carries the full
        result. With stop strings the deltas come from the cumulative
        text, cut before a stop string, and a possibly incomplete
        trailing character or a prefix of a stop string is held back
        until the next chunk resolves it. A chunk's text decodes only
        its own tokens otherwise; the final result's text is the
        authority."""
        st = self._start(request)
        tok = st["tok"]
        eos = tok.eos_id
        chunk_bucket = _bucket(min(chunk_tokens, request.max_new_tokens), GEN_BUCKETS)
        generated = [st["first_id"]]
        # The plain loop only stops on an EOS sampled inside it; an EOS
        # first token under stop_at_eos leaves nothing to show.
        stop = request.stop_at_eos and generated[0] == eos
        emitted = ""
        owed: "list[int]" = []  # ids not yet attached to a chunk

        def stop_delta() -> "Tuple[str, bool]":
            nonlocal emitted
            cum = tok.decode(generated)
            cuts = [cum.find(s) for s in request.stop if s in cum]
            if cuts:
                cum = cum[: min(cuts)]
            else:
                if cum.endswith("\ufffd"):
                    cum = cum[:-1]
                hold = 0
                for s in request.stop:
                    for k in range(min(len(s) - 1, len(cum)), 0, -1):
                        if cum.endswith(s[:k]):
                            hold = max(hold, k)
                            break
                if hold:
                    cum = cum[:-hold]
            delta = cum[len(emitted):] if len(cum) > len(emitted) else ""
            emitted += delta
            return delta, bool(cuts)

        def emit(ids: "list[int]"):
            nonlocal owed, stop
            if not request.stop:
                return GenerationChunk(text=tok.decode(ids), tokens=ids)
            owed = owed + ids
            delta, hit = stop_delta()
            stop = stop or hit
            if not delta:
                return None
            chunk, owed = GenerationChunk(text=delta, tokens=owed), []
            return chunk

        if not stop:
            first = emit(list(generated))
            if first is not None:
                yield first
        remaining = request.max_new_tokens - 1
        while remaining > 0 and not stop:
            ids = self._decode_plain(request, st, min(chunk_bucket, remaining))
            generated.extend(ids)
            remaining -= len(ids)
            shown = list(ids)
            if ids[-1] == eos:
                stop = True
                if request.stop_at_eos:
                    shown = shown[: shown.index(eos)]
            if shown:
                chunk = emit(shown)
                if chunk is not None:
                    yield chunk
        if request.stop:
            # the held-back text, so that the deltas sum to the result's
            final = generated
            if request.stop_at_eos and eos in final:
                final = final[: final.index(eos)]
            cum = tok.decode(final)
            cuts = [cum.find(s) for s in request.stop if s in cum]
            if cuts:
                cum = cum[: min(cuts)]
            if len(cum) > len(emitted) or owed:
                yield GenerationChunk(text=cum[len(emitted):], tokens=owed)
        self._sync()
        t2 = time.monotonic()
        yield GenerationChunk(
            text="", tokens=[], done=True, result=self._finish(request, generated, st, t2)
        )

    def _finish(
        self, request: GenerationRequest, generated: "list[int]", st: Dict[str, Any], t2: float
    ) -> GenerationResult:
        eos = st["tok"].eos_id
        if request.stop_at_eos and eos in generated:
            generated = generated[: generated.index(eos)]
        text = st["tok"].decode(generated)
        if request.stop:
            generated, text = _apply_stop(generated, text, st["tok"], request.stop)
        result = GenerationResult(
            request=request,
            tokens=generated,
            text=text,
            prompt_tokens=st["s_real"],
            generated_tokens=len(generated),
            prefill_s=st["t1"] - st["t0"],
            decode_s=t2 - st["t1"],
            total_s=t2 - st["t0"],
        )
        self._observe_result(result, st, t2)
        return result

    # -- speculative decoding ---------------------------------------------------
    def _resolve_spec(self, model: str) -> Optional[DraftSpec]:
        """The DraftSpec for ``model``: its own entry, else ``"default"``
        (which never makes a model draft for itself)."""
        spec = self.speculative.get(model)
        if spec is None:
            spec = self.speculative.get("default")
            if spec is not None and spec.draft == model:
                return None
        return spec

    @staticmethod
    def _spec_source_key(source: str, draft: Optional[str]) -> str:
        return f"{source}:{draft or ''}"

    def _spec_source_feedback(self, source: str, draft: Optional[str], acceptance: float) -> None:
        """Record one session's fallback acceptance under its source (the
        last 8 are kept)."""
        window = self._spec_source_health.setdefault(self._spec_source_key(source, draft), [])
        window.append(float(acceptance))
        del window[:-8]

    def _spec_source_clear(self, source: str, draft: Optional[str]) -> None:
        """A session speculated to its close: forget the source's fallbacks."""
        self._spec_source_health.pop(self._spec_source_key(source, draft), None)

    def _spec_source_blocked(self, source: str, draft: Optional[str], floor: float) -> bool:
        """Whether a new session skips arming this source: at least two
        recent fallbacks whose mean acceptance is under ``floor``. A
        consult that blocks drops the oldest entry, so the source re-arms
        after a few skipped sessions."""
        if floor <= 0.0:
            return False
        window = self._spec_source_health.get(self._spec_source_key(source, draft))
        if window is None or len(window) < 2:
            return False
        blocked = sum(window) / len(window) < floor
        if blocked:
            window.pop(0)
        return blocked

    def _spec_eligible(self, request: GenerationRequest) -> bool:
        """Greedy rows and sampled rows up to ``spec_temperature_max``
        speculate; a repeat penalty never does (it changes the modified
        distribution per emitted token, which a k-wide proposal cannot
        follow)."""
        return request.repeat_penalty == 1.0 and (
            request.temperature == 0.0 or request.temperature <= self.spec_temperature_max
        )

    def generate_speculative(
        self,
        request: GenerationRequest,
        draft_model: Optional[str] = None,
        k: int = 4,
        prompt_ids: "Optional[list[int]]" = None,
        source: str = "model",
    ) -> GenerationResult:
        """Draft-and-verify decoding of one request (``engine/speculative.py``).
        A greedy request with a model or cross draft runs the solo loop
        over contiguous caches that carry a ``2k+2``-slot margin (the
        draft must share the target's vocabulary); a sampled or n-gram
        request drains a one-row stepped session on the engine's KV layout.
        ``extras`` report rounds and accepted drafts."""
        if request.repeat_penalty != 1.0:
            raise ValueError(
                "speculative decoding requires repeat_penalty=1 (the presence "
                "penalty changes the modified distribution per emitted token, "
                "which a k-wide proposal step cannot follow)"
            )
        if request.temperature != 0.0 or source == "ngram":
            override = DraftSpec(source, None if source == "ngram" else draft_model, k)
            session = self.decode_open([request], spec_override=override)
            try:
                results: "list[GenerationResult]" = []
                while session.active:
                    results.extend(session.step())
            finally:
                session.close()
            result = results[0]
            spec_x = result.extras.get("spec")
            if spec_x is not None:
                # the flat keys of the solo greedy path's extras
                result.extras.update(
                    spec_rounds=spec_x["rounds"], spec_accepted=spec_x["accepted"],
                    draft_model=spec_x["draft_model"], k=spec_x["k"],
                )
            return result
        model = request.model
        self.load_model(model)
        self.load_model(draft_model)
        if model not in self._models:  # the draft's load evicted the target: one retry
            self.load_model(model)
        if model not in self._models or draft_model not in self._models:
            # the pair cannot be resident together under the budget: plain
            # greedy decode gives the same tokens
            from ..runner import term

            term.log_warn(
                f"speculative decoding: {model} and {draft_model} cannot be co-resident "
                "under the device allocation budget; falling back to plain decode"
            )
            return self._generate_plain(request, prompt_ids=prompt_ids)
        tcfg = self._models[model].cfg
        dcfg = self._models[draft_model].cfg
        if tcfg.vocab_size != dcfg.vocab_size:
            raise ValueError(
                f"draft {draft_model} vocab {dcfg.vocab_size} != target "
                f"{model} vocab {tcfg.vocab_size}"
            )
        if prompt_ids is None:
            prompt_ids = self._tokenizer_for(model).encode(request.prompt)
        s_real = len(prompt_ids)
        cache_len = (
            _prompt_alloc(s_real) + _bucket(request.max_new_tokens, GEN_BUCKETS) + _spec_margin(k)
        )
        st = self._start(request, cache_len=cache_len, prompt_ids=prompt_ids)
        if self.kv_quantize:
            # the target verifies over the int8 cache; the draft's stays
            # in the engine dtype
            st["k_cache"], st["v_cache"] = quantize_kv_cache(st["k_cache"], st["v_cache"])
        _, dkc, dvc = self._run_prefill(draft_model, prompt_ids, cache_len)
        key = ("spec", model, draft_model, k)
        if key not in self._decode_cache:
            self._decode_cache[key] = build_spec_fn(
                tcfg, dcfg, k, st["tok"].eos_id, cuda_decode_attention
            )
        out, n_em, rounds, accepted = self._decode_cache[key](
            self._models[model], self._models[draft_model], st["first"], s_real,
            st["k_cache"], st["v_cache"], dkc, dvc, request.max_new_tokens - 1,
        )
        self._sync()
        t2 = time.monotonic()
        take = min(n_em, request.max_new_tokens - 1)
        result = self._finish(request, [st["first_id"]] + out[:take], st, t2)
        result.extras = {
            **(result.extras or {}),
            "spec_rounds": rounds,
            "spec_accepted": accepted,
            "draft_model": draft_model,
            "k": k,
            "spec": {
                "rounds": rounds, "accepted": accepted, "drafted": rounds * k, "k": k,
                "draft_model": draft_model, "source": source,
            },
        }
        if _obs_enabled():
            try:
                from ..obs.flight import EV_SPEC_ROUND, FLIGHT, trace_of
                from ..obs.metrics import observe_spec

                observe_spec(rounds, accepted, rounds * k, source=source)
                FLIGHT.emit(
                    EV_SPEC_ROUND, trace=trace_of(_TRACER.current()), model=model,
                    draft=draft_model, source=source, k=k, rounds=rounds, accepted=accepted,
                    acceptance=round(accepted / (rounds * k), 4) if rounds else None,
                )
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        return result

    def _spec_batch_decode_step_fn(
        self,
        model: str,
        draft_model: Optional[str],
        k: int,
        n_steps: int,
        source: str,
        top_k: int,
        use_top_p: bool,
        paged: bool = True,
    ) -> Callable:
        """The speculative slice step of a session
        (:func:`build_spec_step_fn`), one per key: the draft's steps run
        the decode kernel on its batch cache; a paged session's verify
        reads the prompt pages through :func:`_paged_parts`, a contiguous
        one's its cache rows through :func:`_contiguous_attention` (the
        multi-query kernels either way)."""
        key = (
            "spec-step", model, draft_model, k, n_steps, source, top_k, use_top_p,
            self.spec_draft_temperature, paged,
        )
        if key not in self._decode_cache:
            self._decode_cache[key] = build_spec_step_fn(
                self._models[model].cfg,
                self._models[draft_model].cfg if draft_model is not None else None,
                k, n_steps, self._tokenizer_for(model).eos_id,
                draft_decode_attention=cuda_decode_attention,
                decode_attention=_paged_parts if paged else _contiguous_attention,
                source=source, top_k=top_k, use_top_p=use_top_p,
                draft_temperature=self.spec_draft_temperature, paged=paged,
            )
        return self._decode_cache[key]

    def decode_open(
        self,
        requests: "list[GenerationRequest]",
        reserve_rows: Optional[int] = None,
        slice_steps: Optional[int] = None,
        spec_accept_floor: Optional[float] = None,
        spec_override: Optional[DraftSpec] = None,
    ):
        """Open a stepped decode session over ``requests``, on the
        engine's KV layout (contiguous, or the paged pool): every row
        prefills now, then each ``session.step()`` runs one slice and
        returns the rows that retired in it. With a speculative config
        for the model (or ``spec_override``) and every row eligible, the
        session's slices are draft-verify rounds (``engine/stepped.py``),
        on either layout."""
        from .stepped import SteppedDecodeSession

        return SteppedDecodeSession.open(
            self, requests, reserve_rows=reserve_rows, slice_steps=slice_steps,
            spec_accept_floor=spec_accept_floor, spec_override=spec_override,
        )

    # -- batched generation over the paged pool ---------------------------------
    def _batch_states(
        self,
        requests: "list[GenerationRequest]",
        all_prompt_ids: "list[list[int]]",
        cache_len: Optional[int] = None,
    ) -> "list[Dict[str, Any]]":
        """Per-row prefill states with GROUPED prefill, each cache sized to
        its prompt (``_prompt_alloc``: the pages take the K/V afterwards),
        or, with ``cache_len``, every cache that wide (the contiguous
        layouts: the rows decode in place).

        Rows whose prompts are single-chunk and share a prompt bucket
        prefill together as one padded ``[G, bucket]`` forward
        (G rounded up to a batch bucket; pad rows repeat the first row),
        then sample their first tokens with :func:`sample_token_per_row`,
        each from a fresh generator seeded like a solo request's, so each
        row's stream is a solo :meth:`generate`'s. Such a row's state holds
        the group's shared arrays (``st["group"]``: caches [L, Gb, Hkv, T,
        D], first tokens, generators) and its index ``st["gi"]``; rows
        share the group's prefill wall clock as ``prefill_s``. Multi-chunk
        prompts and groups of one take the solo :meth:`_start`."""
        model = requests[0].model
        self.load_model(model)
        tf = self._models[model]
        cfg = tf.cfg
        tok = self._tokenizer_for(model)

        states: "list[Optional[Dict[str, Any]]]" = [None] * len(requests)
        groups: "Dict[int, list[int]]" = {}  # prompt bucket -> rows
        for i, ids in enumerate(all_prompt_ids):
            chunks = _prompt_chunks(len(ids))
            # A single-chunk row with a cached prefix prefills solo (a copy
            # and the rest); only such rows probe, since multi-chunk rows
            # go solo anyway and their prefill repeats the scan.
            if ids and len(chunks) == 1 and self._find_prefix(model, ids) is None:
                groups.setdefault(chunks[0][1], []).append(i)
            else:  # multi-chunk; an empty prompt fails there as a solo one does
                states[i] = self._start(
                    requests[i], cache_len=cache_len or _prompt_alloc(len(ids)), prompt_ids=ids
                )

        for bucket, idxs in groups.items():
            if len(idxs) == 1:  # no grouping win; identical solo semantics
                i = idxs[0]
                states[i] = self._start(
                    requests[i], cache_len=cache_len or bucket, prompt_ids=all_prompt_ids[i]
                )
                continue
            t0 = time.monotonic()
            g = len(idxs)
            gb = _bucket(g, BATCH_BUCKETS)
            row_ids = [all_prompt_ids[i] for i in idxs]
            row_ids += [row_ids[0]] * (gb - g)
            row_reqs = [requests[i] for i in idxs]
            tokens = torch.tensor(
                [ids + [tok.pad_id] * (bucket - len(ids)) for ids in row_ids],
                dtype=torch.long, device=self.device,
            )
            last_index = torch.tensor([len(ids) - 1 for ids in row_ids], device=self.device)
            k_cache, v_cache = tf.init_cache(gb, cache_len or bucket, dtype=self.dtype)
            hidden, k_cache, v_cache = forward(
                tf.params, cfg, tokens, 0, k_cache, v_cache,
                None, cuda_prefill_attention, layers=tf.layers,
            )
            logits = logits_for(
                tf.params, cfg, hidden[torch.arange(gb, device=self.device), last_index]
            )
            # Pad rows are greedy and hold no generator, so they never
            # advance a real row's stream.
            gens = [torch.Generator(device=self.device).manual_seed(r.seed) for r in row_reqs]
            gens += [None] * (gb - g)
            knobs = self._row_knobs(row_reqs, gb)
            presence = None
            if any(r.repeat_penalty != 1.0 for r in row_reqs):
                presence = torch.zeros((gb, cfg.vocab_size), dtype=torch.bool, device=self.device)
                for gi, (r, ids) in enumerate(zip(row_reqs, row_ids)):
                    if r.repeat_penalty != 1.0:
                        presence[gi, torch.tensor(ids, device=self.device)] = True
            firsts = sample_token_per_row(
                logits, gens, knobs["temperature"], row_reqs[0].top_k,
                knobs["top_p"], presence, knobs["repeat_penalty"],
            )
            self._sync()
            t1 = time.monotonic()
            if _obs_enabled():
                _PREFILL_H.observe(t1 - t0)
                _TRACER.add_span(
                    "prefill", t0, t1, attrs={"model": model, "rows": g, "bucket": bucket}
                )
            shared = {"k": k_cache, "v": v_cache, "first": firsts, "gen": gens}
            for gi, i in enumerate(idxs):
                states[i] = {
                    "s_real": len(all_prompt_ids[i]), "t0": t0, "t1": t1,
                    "group": shared, "gi": gi,
                }
        return states  # type: ignore[return-value]

    @staticmethod
    def _row_knobs(requests: "list[GenerationRequest]", width: int) -> Dict[str, list]:
        """Per-row sampling knobs as host lists, padded to ``width`` with
        greedy, unfiltered, unpenalised rows."""
        pad = width - len(requests)
        return {
            "temperature": [r.temperature for r in requests] + [0.0] * pad,
            "top_p": [r.top_p for r in requests] + [1.0] * pad,
            "repeat_penalty": [r.repeat_penalty for r in requests] + [1.0] * pad,
        }

    @staticmethod
    def _row_field_specs(
        states: "list[Dict[str, Any]]",
    ) -> "list[Tuple[str, Callable[[list], Any]]]":
        """The fields :meth:`_assemble_rows` gathers (first tokens and
        generators), each with its builder for solo-prefilled rows. The
        decode loop's presence mask is rebuilt from the prompts and first
        tokens instead (:meth:`_generate_batch_paged`)."""
        return [
            ("first", lambda rows: torch.cat([states[r]["first"] for r in rows])),
            ("gen", lambda rows: [states[r]["gen"] for r in rows]),
        ]

    def _assemble_rows(
        self,
        states: "list[Dict[str, Any]]",
        b_bucket: int,
        fields: "list[Tuple[str, Callable[[list], Any]]]",
    ) -> Dict[str, Any]:
        """Per-row batch fields from the grouped-prefill states: one gather
        per group per field and one permutation, instead of one slice per
        row. Group fields are tensors (gathered along dim 0) or lists of
        generators; rows without a group come from the field's builder.
        Pad rows (``b_bucket`` − len(states)) repeat row 0. A field spec
        is ``(name, builder)`` or ``(name, builder, dim)``: its rows lie
        along ``dim`` (the caches [L, B, Hkv, T, D] along 1). Also returns
        ``_groups`` {id: (shared, member rows)} for the page chunks."""
        n = len(states)
        groups: "Dict[int, Tuple[Dict[str, Any], list[int]]]" = {}
        for r, st in enumerate(states):
            if "group" in st:
                groups.setdefault(id(st["group"]), (st["group"], []))[1].append(r)
        solo_rows = [r for r, st in enumerate(states) if "group" not in st]
        perm = [0] * b_bucket
        pos = 0
        for _, members in groups.values():
            for j, r in enumerate(members):
                perm[r] = pos + j
            pos += len(members)
        for j, r in enumerate(solo_rows):
            perm[r] = pos + j
        perm[n:] = [perm[0]] * (b_bucket - n)

        def take(x, idx, dim):
            if isinstance(x, list):
                return [x[i] for i in idx]
            if idx == list(range(x.shape[dim])):
                return x  # identity gather: no copy
            return x.index_select(dim, torch.tensor(idx, device=x.device))

        out: Dict[str, Any] = {"_groups": groups}
        for name, solo_builder, *rest in fields:
            dim = rest[0] if rest else 0
            parts = [
                take(shared[name], [states[r]["gi"] for r in members], dim)
                for shared, members in groups.values()
            ]
            if solo_rows:
                parts.append(solo_builder(solo_rows))
            if isinstance(parts[0], list):
                cat = [x for part in parts for x in part]
            else:
                cat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
            out[name] = take(cat, perm, dim)
        return out

    def _generate_batch_paged(
        self,
        requests: "list[GenerationRequest]",
        all_prompt_ids: "list[list[int]]",
    ) -> "list[GenerationResult]":
        """Grouped prefill at each row's own bucket; the prompts' K/V
        scattered into a page pool in whole pages (one indexed copy per
        pool tensor; int8 pools quantize the chunks first); then one decode
        loop over the read-only pool and side caches for the generated
        tokens. Pages cover the prompts only: the pool is never written
        during decode."""
        model = requests[0].model
        top_k = requests[0].top_k
        tf = self._models[model]
        cfg = tf.cfg
        tok = self._tokenizer_for(model)
        page = self.page_size
        n_real = max(r.max_new_tokens for r in requests) - 1
        states = self._batch_states(requests, all_prompt_ids)
        rows_pages = [-(-st["s_real"] // page) for st in states]

        n = len(states)
        b_bucket = _bucket(n, BATCH_BUCKETS)
        pad_rows = b_bucket - n
        fused_rows = [r for r, st in enumerate(states) if "group" in st]
        # Pad rows enter decode done and read one private page; grouped
        # rows send their bucket-tail chunks past the prompt to one shared
        # garbage page (never a real row's page).
        total_pages = sum(rows_pages) + (1 if pad_rows else 0) + (1 if fused_rows else 0)
        n_pages = _pow2_at_least(total_pages, 4)
        jmax = _pow2_at_least(max(rows_pages or [1]))
        n_layers, n_kv_heads = self._kv_dims(cfg)
        pool = PagePool.create(
            n_layers=n_layers, n_pages=n_pages, n_kv_heads=n_kv_heads,
            d_head=cfg.d_head, page_size=page, dtype=self.dtype,
            quantized=bool(self.kv_quantize), device=self.device,
        )
        # Entries past a row's need stay 0 and are never read (the kernels
        # stop at the row's length).
        table_rows = [[0] * jmax for _ in range(b_bucket)]
        row_pages: "list[list[int]]" = []
        for r, need in enumerate(rows_pages):
            pages = pool.alloc(need)
            row_pages.append(pages)
            table_rows[r][:need] = pages
        garbage = pool.alloc(1)[0] if fused_rows else None
        if pad_rows:
            private = pool.alloc(1)[0]
            for r in range(n, b_bucket):
                table_rows[r] = [private] * jmax

        asm = self._assemble_rows(states, b_bucket, self._row_field_specs(states))
        self._scatter_prompts(pool, states, asm["_groups"], row_pages, garbage)
        del asm["_groups"]
        st = self._rows_state(requests, all_prompt_ids, states, asm, b_bucket)
        del asm
        st.update(
            pool=pool, table=torch.tensor(table_rows, dtype=torch.int32, device=self.device),
        )
        st["side_k"], st["side_v"] = self._side_caches(
            cfg, b_bucket, _bucket(max(r.max_new_tokens for r in requests), GEN_BUCKETS)
        )
        return self._run_batch(requests, states, st, "paged")

    def _generate_batch_contiguous(
        self,
        requests: "list[GenerationRequest]",
        all_prompt_ids: "list[list[int]]",
    ) -> "list[GenerationResult]":
        """Grouped prefill straight into one contiguous cache [L, B, Hkv,
        T, D] of ``T`` = the widest prompt allocation + the widest
        generation bucket (every row at that shape; an int8-KV engine
        quantizes it once, per position and head, so each row is its solo
        cache); then one decode loop in which each row writes and reads
        its own row at its own offset (B2, or B3 over int8)."""
        model = requests[0].model
        cfg = self._models[model].cfg
        cache_len = max(_prompt_alloc(len(ids)) for ids in all_prompt_ids) + _bucket(
            max(r.max_new_tokens for r in requests), GEN_BUCKETS
        )
        if cache_len > cfg.max_seq_len:
            raise ValueError(
                f"{model}: batch cache {cache_len} exceeds max_seq_len {cfg.max_seq_len}"
            )
        states = self._batch_states(requests, all_prompt_ids, cache_len=cache_len)
        b_bucket = _bucket(len(states), BATCH_BUCKETS)
        st = self._contiguous_state(requests, all_prompt_ids, states, b_bucket)
        return self._run_batch(requests, states, st, "contiguous")

    def _contiguous_state(
        self,
        requests: "list[GenerationRequest]",
        all_prompt_ids: "list[list[int]]",
        states: "list[Dict[str, Any]]",
        b_bucket: int,
    ) -> Dict[str, Any]:
        """The rows' decode state (:meth:`_rows_state`) over one batch
        cache assembled from the prefill states (groups gathered along the
        batch dim, pad rows a copy of row 0's), quantized for an int8-KV
        engine. Frees the prefill caches from ``states``."""

        def solo(key):
            return lambda rows: torch.cat([states[r][key] for r in rows], dim=1)

        fields = self._row_field_specs(states) + [
            ("k", solo("k_cache"), 1), ("v", solo("v_cache"), 1),
        ]
        asm = self._assemble_rows(states, b_bucket, fields)
        del asm["_groups"]
        for state in states:
            for key in ("group", "k_cache", "v_cache"):
                state.pop(key, None)
        k_cache, v_cache = asm.pop("k"), asm.pop("v")
        if self.kv_quantize:
            k_cache, v_cache = quantize_kv_cache(k_cache, v_cache)
        st = self._rows_state(requests, all_prompt_ids, states, asm, b_bucket)
        st.update(k_cache=k_cache, v_cache=v_cache)
        return st

    def _run_batch(
        self,
        requests: "list[GenerationRequest]",
        states: "list[Dict[str, Any]]",
        st: Dict[str, Any],
        path: str,
    ) -> "list[GenerationResult]":
        """The batch's decode window over the assembled state ``st``, then
        one result per request (its first token, then its steps up to its
        budget, cut at EOS or a stop string)."""
        model, top_k = requests[0].model, requests[0].top_k
        tf = self._models[model]
        tok = self._tokenizer_for(model)
        n_real = max(r.max_new_tokens for r in requests) - 1
        first_host = st["tokens"].tolist()
        self._sync()  # the state's assembly stays out of the decode window
        t1 = time.monotonic()
        out, n_row = self._decode_steps(tf, st, n_real, top_k, tok.eos_id)
        out_host = out.tolist()
        n_row = n_row.tolist()
        self._sync()
        t2 = time.monotonic()
        window_id = next(_DECODE_WINDOW_IDS)

        results = []
        for r, (request, state) in enumerate(zip(requests, states)):
            take = min(n_row[r], request.max_new_tokens - 1)
            generated = [int(first_host[r])] + out_host[r][:take]
            if request.stop_at_eos and tok.eos_id in generated:
                generated = generated[: generated.index(tok.eos_id)]
            text = tok.decode(generated)
            if request.stop:
                generated, text = _apply_stop(generated, text, tok, request.stop)
            prefill_s = state["t1"] - state["t0"]
            results.append(GenerationResult(
                request=request, tokens=generated, text=text,
                prompt_tokens=state["s_real"], generated_tokens=len(generated),
                prefill_s=prefill_s, decode_s=t2 - t1, total_s=prefill_s + (t2 - t1),
                extras={"decode_window": window_id},
            ))
        self._observe_batch_window(results, t1, t2, path)
        return results

    def _scatter_prompts(
        self,
        pool: PagePool,
        states: "list[Dict[str, Any]]",
        groups: "Dict[int, Tuple[Dict[str, Any], list[int]]]",
        row_pages: "list[list[int]]",
        spare: Optional[int],
    ) -> None:
        """Scatter every row's prompt K/V into its pages with one indexed
        copy per pool tensor (an int8 pool quantizes the chunks first).
        Grouped rows are paginated a group at a time; their bucket-tail
        chunks past the prompt go to page ``spare``, which no row reads.
        Frees the prefill caches (group and solo) from ``states``."""
        page = self.page_size
        chunk_dest: "list[int]" = []
        chunks_k, chunks_v = [], []
        for shared, members in groups.values():
            ck, cv = group_chunks(
                shared["k"], shared["v"], [states[r]["gi"] for r in members], page
            )
            chunks_k.append(ck)
            chunks_v.append(cv)
            tp = -(-shared["k"].shape[3] // page)
            for r in members:
                chunk_dest.extend(
                    row_pages[r][j] if j < len(row_pages[r]) else spare for j in range(tp)
                )
        for r, st in enumerate(states):
            if "group" in st:
                continue
            chunk_dest.extend(row_pages[r])
            chunks_k.append(_paginate(st["k_cache"][:, 0], st["s_real"], page))
            chunks_v.append(_paginate(st["v_cache"][:, 0], st["s_real"], page))
        all_k = chunks_k[0] if len(chunks_k) == 1 else torch.cat(chunks_k)
        all_v = chunks_v[0] if len(chunks_v) == 1 else torch.cat(chunks_v)
        if pool.quantized:
            all_k, all_v = quantize_chunks(all_k, all_v)
        scatter_pages(pool.k, pool.v, chunk_dest, all_k, all_v)
        for st in states:
            for key in ("group", "k_cache", "v_cache"):
                st.pop(key, None)

    def _rows_state(
        self,
        requests: "list[GenerationRequest]",
        all_prompt_ids: "list[list[int]]",
        states: "list[Dict[str, Any]]",
        asm: Dict[str, Any],
        b_bucket: int,
    ) -> Dict[str, Any]:
        """The per-row decode state of a batch or session (pad rows up to
        ``b_bucket`` enter done with a budget of 0): first tokens,
        generators, host sampling knobs, prompt lengths and offsets, step
        budgets, the done-mask and, with any repeat penalty, the presence
        mask of the prompts and first tokens (a solo request's)."""
        n = len(states)
        pad_rows = b_bucket - n
        first_tokens = asm["first"]
        presence = None
        if any(r.repeat_penalty != 1.0 for r in requests):
            first_host = first_tokens.tolist()
            vocab = self._models[requests[0].model].cfg.vocab_size
            presence = torch.zeros((b_bucket, vocab), dtype=torch.bool, device=self.device)
            for r, (request, ids) in enumerate(zip(requests, all_prompt_ids)):
                if request.repeat_penalty != 1.0:
                    presence[r, torch.tensor(ids + [first_host[r]], device=self.device)] = True
        prompt_lens = [st["s_real"] for st in states] + [states[0]["s_real"]] * pad_rows
        return {
            "tokens": first_tokens,
            "gens": asm["gen"][:n] + [None] * pad_rows,  # pad rows hold no stream
            "knobs": self._row_knobs(requests, b_bucket),
            "presence": presence,
            "prompt_lens": torch.tensor(prompt_lens, dtype=torch.int32, device=self.device),
            "offsets": torch.tensor(prompt_lens, dtype=torch.long, device=self.device),
            "remaining": torch.tensor(
                [r.max_new_tokens - 1 for r in requests] + [0] * pad_rows, device=self.device
            ),
            "done": torch.tensor(
                [r.max_new_tokens <= 1 for r in requests] + [True] * pad_rows, device=self.device
            ),
        }

    def _kv_dims(self, cfg: ModelConfig) -> Tuple[int, int]:
        """The leading (layer) and head extents of the KV leaves this
        engine allocates for ``cfg``: the model's own here; a sharded
        engine folds its shards into the layer axis (``parallel/tp.py``)."""
        return cfg.n_layers, cfg.n_kv_heads

    def _dp_shards(self) -> int:
        """The dp extent stepped sessions split their rows over: 1 here; a
        sharded engine's mesh ``dp`` (``parallel/tp.py``)."""
        return 1

    def _side_caches(self, cfg: ModelConfig, b: int, cols: int):
        """Zeroed K and V side caches [L, B, Hkv, cols, D] of the engine's
        KV representation (int8: codes and f32 scales)."""
        n_layers, n_kv_heads = self._kv_dims(cfg)
        shape = (n_layers, b, n_kv_heads, cols, cfg.d_head)

        def side():
            if self.kv_quantize:
                return {
                    "q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32, device=self.device),
                }
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return side(), side()

    def _decode_attention_for_cache(self):
        """The decode kernel matching the contiguous cache's
        representation: B2 over a bf16/f32 cache, B3 over int8 codes and
        scales (the JAX engine's dispatch of the same name)."""
        return _int8_cache_attention if self.kv_quantize else cuda_decode_attention

    def _decode_steps(
        self, tf, st: Dict[str, Any], n_real: int, top_k: int, eos: int,
    ) -> "Tuple[torch.Tensor, torch.Tensor]":
        """Up to ``n_real`` batched decode steps, over the paged pool
        (``st["pool"]``) or a contiguous batch cache (``st["k_cache"]``).
        Paged: each row writes its step's K/V into the side caches at its
        own ``write_pos = offset - prompt_len``, and attention merges the
        parts kernel's prompt term with the side term. Contiguous: each
        row writes and reads its own cache row at its own offset (B2/B3).
        A row is done at EOS or when its ``remaining`` budget is spent; a
        done row emits EOS and its offset freezes (it rewrites one column
        of its own). Stops early when every row is done, as the JAX
        engine's ``while_loop`` condition does. Updates ``st`` (tokens,
        offsets, done, remaining; presence and caches in place) so that a
        later call continues the rows. Returns (out [B, n_real] tokens,
        n_row [B] steps each row ran)."""
        cfg = tf.cfg
        token, offs, done = st["tokens"], st["offsets"], st["done"]
        budgets, plens = st["remaining"], st["prompt_lens"]
        presence, knobs = st["presence"], st["knobs"]
        b = token.shape[0]
        out = torch.full((b, n_real), eos, dtype=torch.long, device=self.device)
        n_row = torch.zeros((b,), dtype=torch.long, device=self.device)
        rows = torch.arange(b, device=self.device)
        i = 0
        paged = "pool" in st
        attention = _paged_parts if paged else self._decode_attention_for_cache()
        while i < n_real and not bool(done.all()):
            if paged:
                leaf = {"table": st["table"], "write_pos": offs - plens, "prompt_lens": plens}
                kc = {**leaf, "pool": st["pool"].k, "side": st["side_k"]}
                vc = {**leaf, "pool": st["pool"].v, "side": st["side_v"]}
            else:
                kc, vc = st["k_cache"], st["v_cache"]
            hidden, _, _ = forward(
                tf.params, cfg, token[:, None], offs, kc, vc, attention, layers=tf.layers
            )
            logits = logits_for(tf.params, cfg, hidden[:, 0])
            nxt = sample_token_per_row(
                logits, st["gens"], knobs["temperature"], top_k, knobs["top_p"],
                presence, knobs["repeat_penalty"],
            )
            prev_done = done
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            done = done | (nxt == eos) | (i + 1 >= budgets)
            if presence is not None:
                presence[rows, nxt] = True
            out[:, i] = nxt
            n_row = torch.where(prev_done, n_row, torch.full_like(n_row, i + 1))
            offs = torch.where(done, offs, offs + 1)
            token = nxt
            i += 1
        st.update(tokens=token, offsets=offs, done=done, remaining=budgets - n_row)
        return out, n_row

    def _contiguous_row_bytes(self, cfg: ModelConfig, s_bucket: int, g_bucket: int) -> int:
        """K+V bytes one row pins in a contiguous batch cache (every row at
        the widest prompt + generation bucket); int8: D codes + a 4-byte
        scale per (position, head) vector."""
        per_col = cfg.d_head + 4 if self.kv_quantize else cfg.d_head * self._itemsize()
        return 2 * cfg.n_layers * cfg.n_kv_heads * (s_bucket + g_bucket) * per_col

    def _itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def _paged_chunk_bytes(
        self, cfg: ModelConfig, chunk_pages: "list[int]", b_bucket: int, g_bucket: int
    ) -> int:
        """K+V bytes one paged sub-batch allocates: the pow2-rounded pool
        (each row billed its own pages, plus the garbage and pad pages) and
        the side caches, exactly as :meth:`_generate_batch_paged` allocates.

        The port's pool keeps the native head dim, while the JAX engine
        pads stacked pools to 128 lanes (a TPU tiling rule), and the port
        has only the stacked-hybrid mode. So at D 128 (qwen2) this bill
        equals the JAX package's, and at D 96 (phi3) it is smaller."""
        total = sum(chunk_pages) + 2  # + the shared garbage/pad pages
        n_pages = _pow2_at_least(total, 4)
        col = cfg.d_head + 4 if self.kv_quantize else cfg.d_head * self._itemsize()
        pool_bytes = 2 * cfg.n_layers * n_pages * cfg.n_kv_heads * self.page_size * col
        side_bytes = 2 * cfg.n_layers * b_bucket * cfg.n_kv_heads * g_bucket * col
        return pool_bytes + side_bytes

    def _paged_rows_cap(self, cfg: ModelConfig, rows_pages: "list[int]", g_bucket: int) -> int:
        """Widest batch bucket whose every sequential chunk's pool + side
        bytes fit BATCH_KV_BUDGET_BYTES (floor BATCH_MIN_SPLIT_ROWS)."""
        max_rows = BATCH_MIN_SPLIT_ROWS
        for b in BATCH_BUCKETS:
            if b <= max_rows:
                continue
            chunks = [rows_pages[i : i + b] for i in range(0, len(rows_pages), b)]
            if all(
                self._paged_chunk_bytes(cfg, c, _bucket(len(c), BATCH_BUCKETS), g_bucket)
                <= BATCH_KV_BUDGET_BYTES
                for c in chunks
            ):
                max_rows = b
        return max_rows

    def _max_batch_rows(
        self,
        cfg: ModelConfig,
        requests: "list[GenerationRequest]",
        all_prompt_ids: "list[list[int]]",
    ) -> int:
        """Widest batch bucket whose estimated K+V footprint fits
        BATCH_KV_BUDGET_BYTES (floor BATCH_MIN_SPLIT_ROWS). Paged batches
        bill each row its own prompt pages; contiguous batches bill every
        row at the widest shape."""
        g_bucket = _bucket(max(r.max_new_tokens for r in requests), GEN_BUCKETS)
        if self.paged_kv:
            rows_pages = [-(-max(len(ids), 1) // self.page_size) for ids in all_prompt_ids]
            return self._paged_rows_cap(cfg, rows_pages, g_bucket)
        max_rows = BATCH_MIN_SPLIT_ROWS
        s_bucket = max(_prompt_alloc(len(ids)) for ids in all_prompt_ids)
        bytes_per_row = self._contiguous_row_bytes(cfg, s_bucket, g_bucket)
        for b in BATCH_BUCKETS:
            if b > max_rows and b * bytes_per_row <= BATCH_KV_BUDGET_BYTES:
                max_rows = b
        return max_rows

    def max_admission_rows(self, request: GenerationRequest) -> int:
        """Admission cap for a batch window anchored by ``request``: the
        widest batch bucket whose estimated K+V footprint, at this
        request's buckets under this engine's cache layout, fits
        BATCH_KV_BUDGET_BYTES. An estimate only: nothing loads or
        allocates."""
        model = request.model
        cfg = self.registry[model] if model in self.registry else get_model_config(model)
        ids = self._tokenizer_for(model).encode(request.prompt)
        width = max(BATCH_BUCKETS)
        if self.paged_kv and ids and self.prefix_share:
            # Shared-prefix billing: a fleet anchored by this request
            # shares the prompt's full pages, so the first row pays them
            # and every later sharer only its divergent tail (the boundary
            # page copied on write). The session's can_join / join_begin
            # enforce the same rule exactly; this estimate only keeps the
            # cap from under-admitting what the pool can hold.
            need = -(-len(ids) // self.page_size)
            shared = min((len(ids) - 1) // self.page_size, need - 1)
            rows_pages = [need] + [need - shared] * (width - 1)
            g_bucket = _bucket(request.max_new_tokens, GEN_BUCKETS)
            return self._paged_rows_cap(cfg, rows_pages, g_bucket)
        return self._max_batch_rows(cfg, [request] * width, [ids] * width)

    def generate_batch(self, requests: "list[GenerationRequest]") -> "list[GenerationResult]":
        """Generate for several requests in one batched decode: over the
        paged pool (``paged_kv=True``) or one contiguous batch cache.

        Prefill runs grouped by prompt bucket (:meth:`_batch_states`);
        decode runs all rows together, reading the weights once per step
        for the whole batch. Fleets wider than :meth:`_max_batch_rows` run
        as sequential sub-batches. All requests must name one model and
        share ``top_k``. Each result's ``decode_s`` is its sub-batch's
        decode wall time and ``extras["decode_window"]`` names that window;
        grouped rows share their group's ``prefill_s``."""
        if not requests:
            return []
        models = {r.model for r in requests}
        if len(models) > 1:
            raise ValueError(f"one model per batch, got {sorted(models)}")
        top_ks = {r.top_k for r in requests}
        if len(top_ks) > 1:
            raise ValueError(f"one top_k per batch, got {sorted(top_ks)}")
        model = requests[0].model
        self.load_model(model)
        cfg = self._models[model].cfg
        tok = self._tokenizer_for(model)
        all_prompt_ids = [tok.encode(r.prompt) for r in requests]
        max_rows = self._max_batch_rows(cfg, requests, all_prompt_ids)
        results: "list[GenerationResult]" = []
        for i in range(0, len(requests), max_rows):
            results.extend(self._generate_batch_chunk(
                requests[i : i + max_rows], all_prompt_ids[i : i + max_rows]
            ))
        return results

    def _generate_batch_chunk(
        self, requests: "list[GenerationRequest]", all_prompt_ids: "list[list[int]]"
    ) -> "list[GenerationResult]":
        """One memory-bounded sub-batch of :meth:`generate_batch`."""
        model = requests[0].model
        cfg = self._models[model].cfg
        if not self.paged_kv:
            return self._generate_batch_contiguous(requests, all_prompt_ids)
        for r, ids in zip(requests, all_prompt_ids):
            if len(ids) + r.max_new_tokens > cfg.max_seq_len:
                raise ValueError(
                    f"{model}: prompt {len(ids)} + generation {r.max_new_tokens} "
                    f"exceeds max_seq_len {cfg.max_seq_len}"
                )
        return self._generate_batch_paged(requests, all_prompt_ids)

    # -- telemetry --------------------------------------------------------------
    def _obs_labels(self, path: str) -> Dict[str, str]:
        """The labels of a step: the cache layout it ran over
        (``contiguous`` or ``paged``) and the KV representation."""
        return {"path": path, "kv": "int8" if self.kv_quantize else "bf16"}

    def _observe_decode_window(
        self, t1: float, t2: float, tokens: int, steps: int, rows: int = 1,
        path: str = "contiguous",
    ) -> None:
        if not _obs_enabled():
            return
        labels = self._obs_labels(path)
        _DECODE_H.observe(t2 - t1)
        _TOKENS_C.labels(**labels).inc(tokens)
        _STEPS_C.labels(**labels).inc(steps)
        if t2 > t1 and tokens:
            _TOKS_PER_S_G.labels(**labels).set(tokens / (t2 - t1))
        _TRACER.add_span("decode", t1, t2, attrs={"tokens": tokens, "rows": rows, **labels})

    def _observe_result(self, result: GenerationResult, st: Dict[str, Any], t2: float) -> None:
        """Solo-window telemetry + live energy attribution: the run-table
        energy model evaluated on this result (nominal + the coefficient
        box), attached as ``extras["energy_model"]`` and recorded in the
        ``llm_request_*`` families. Telemetry must never fail a request."""
        if not _obs_enabled():
            return
        try:
            n = result.generated_tokens
            self._observe_decode_window(st["t1"], t2, n, n)
            from ..obs import energy as obs_energy

            model = result.request.model
            tf = self._models.get(model)
            if tf is None:
                return
            est = obs_energy.attribute_result(
                tf.cfg, result, quantize=self._quant_mode(model), kv_quantize=self.kv_quantize
            )
            if est is not None:
                result.extras = {**(result.extras or {}), "energy_model": est}
                obs_energy.observe_estimate(est)
                self._note_joules_per_token(model, est)
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _note_joules_per_token(self, model: str, est: Dict[str, Any]) -> None:
        if est.get("J_per_token") is not None:
            self.last_joules_per_token = est["J_per_token"]
            self.last_joules_per_token_by_model[model] = est["J_per_token"]

    def _observe_batch_window(
        self, results: "list[GenerationResult]", t1: float, t2: float, path: str = "paged",
    ) -> None:
        """One shared batch decode window: every row's tokens, and the
        window's steps (the longest row's); then the window's modelled
        Joules (``batch_window_stats``: the weight stream billed once per
        step, each row's KV at its own context), split over the rows by
        token share into ``extras["energy_model"]`` (``window="shared"``)."""
        if not results or not _obs_enabled():
            return
        tokens = sum(r.generated_tokens for r in results)
        self._observe_decode_window(
            t1, t2, tokens, max(r.generated_tokens for r in results),
            rows=len(results), path=path,
        )
        try:
            from ..obs import energy as obs_energy

            model = results[0].request.model
            tf = self._models.get(model)
            if tf is None or not tokens:
                return
            stats = obs_energy.batch_window_stats(
                tf.cfg, results, quantize=self._quant_mode(model),
                kv_quantize=self.kv_quantize, duration_s=t2 - t1,
            )
            est = obs_energy.estimate_from_stats(stats) if stats else None
            if est is None:
                return
            obs_energy.observe_estimate(est)
            self._note_joules_per_token(model, est)
            for r in results:
                if not r.generated_tokens:
                    continue
                share = r.generated_tokens / tokens
                r.extras = {
                    **(r.extras or {}),
                    "energy_model": {
                        "J": round(est["J"] * share, 4),
                        "J_low": round(est["J_low"] * share, 4),
                        "J_high": round(est["J_high"] * share, 4),
                        "J_per_token": est["J_per_token"],
                        "J_per_token_low": est["J_per_token_low"],
                        "J_per_token_high": est["J_per_token_high"],
                        "power_model_W": est["power_model_W"],
                        "window": "shared",  # the row's token share of the batch
                    },
                }
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _slice_energy(
        self, model: str, cfg: ModelConfig, pairs, duration_s: float, steps: int
    ) -> Optional[Dict[str, Any]]:
        """The energy model's estimate of one session slice (or one join
        chunk): ``slice_window_stats`` at this engine's weight and KV
        modes. Sessions split it over their rows by token share."""
        from ..obs import energy as obs_energy

        stats = obs_energy.slice_window_stats(
            cfg, pairs, duration_s, steps,
            quantize=self._quant_mode(model), kv_quantize=self.kv_quantize,
        )
        return obs_energy.estimate_from_stats(stats) if stats is not None else None
