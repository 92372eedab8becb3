"""Iteration-level decode sessions: admit and retire rows at decode-step
granularity, over either of the engine's KV layouts.

Counterpart of the JAX package's ``engine/stepped.py`` on its contiguous
layout (one batch cache [L, B, Hkv, T, D], each row decoding in place at
its own offset: the engine's default) and its stacked paged layout (a
read-only pool of prompt pages, side caches for the generated tokens;
``paged_kv=True``):

- :meth:`SteppedDecodeSession.open` prefills the rows as
  ``generate_batch`` does (grouped prefill; contiguous: straight into the
  batch cache, ``cache_len`` = the widest prompt allocation + the
  generation bucket; paged: the prompts' K/V scattered into a page pool)
  and assembles a resumable decode state at a fixed row bucket;
- :meth:`SteppedDecodeSession.step` runs one bounded slice and retires
  the rows whose done-mask is set (a retired contiguous row freezes its
  offset; a paged row hands its pages back to the pool);
- :meth:`SteppedDecodeSession.join` admits a compatible request into a
  free slot between slices, and its resumable variant
  (:meth:`join_begin` / :meth:`join_step` / :meth:`join_commit` /
  :meth:`join_abort`) prefills the joiner's prompt chunk by chunk into a
  private contiguous cache (chunks at offset > 0 go through the prefill
  kernel as ``generate``'s chunked prefill does), then installs it: the
  whole row into the batch cache (quantized on the way for an int8-KV
  engine), or its pages into those reserved at ``join_begin``; each
  chunk is fenced, so its wall time is the in-flight rows' stall;
- :meth:`cancel` retires a live row without completing it,
  :meth:`stream_deltas` hands out each row's tokens since the last call,
  and :meth:`preempt` parks a live row: ``policy="swap"`` keeps its K/V
  in host memory (a contiguous row's cache slab; a paged row's pool pages
  through ``PagePool.swap_out`` and its side-cache columns),
  ``policy="recompute"`` (contiguous only, as in the JAX package) drops
  it; both keep the control state and the ``torch.Generator`` state, from
  which :meth:`resume_begin` and :meth:`join_commit` re-seat the row (a
  recompute resume re-prefills prompt + generated tokens in join chunks)
  with an unchanged token stream.

The state is one dict, ``self.carry``, that every slice continues. Each
row's tokens equal its solo ``generate``'s: rows are independent across
the batch, a row's sampling consumes its own generator exactly as the
solo loop does, and a joiner's first token is sampled from its own
prefill with a generator seeded as the solo path seeds it.

With a speculative config for the model (the engine's ``speculative=``,
or ``spec_override``) and every opening row eligible, a session's slice
runs draft-verify ROUNDS (``engine/speculative.py::build_spec_step_fn``)
instead of single-token steps: over the paged pool with a k-column
overshoot in the side caches, or over the contiguous batch cache, whose
rows carry the rounds' overshoot margin (``_spec_margin``). It admits any
eligible joiner, whose draft prefill rides the join's chunks after the
target's, and preempts a speculating row with its draft-cache row (swap)
or re-prefills the draft (recompute); an n-gram row's history is rebuilt
from its tokens. With a positive ``spec_accept_floor`` the session adapts
its draft length to a rolling window of acceptance (halving k below the
floor, doubling it back toward the configured k once recovered) and falls
back to plain decode from k = 1 (``_spec_after_slice``); the engine keeps
each source's recent fallbacks and skips arming a source that keeps
failing. A ``cross`` draft's fully rejected rounds are billed to the
wasted-energy ledger (``extras["spec"]["draft_wasted_J"]``).

While a session is open, its model's weights are out of the engine's
LRU guard's reach (``_session_opened`` / ``_session_closed``).

Energy: each slice's wall time and modelled Joules
(``obs/energy.py::slice_window_stats``) split over its rows by token
share, each join chunk's over its joiner; a retiring row closes its
account out into ``extras["energy_model"]`` (``window="slice"``).

With the engine's shared prefix store (``TorchEngine(prefix_share=True)``,
``engine/radix_store.py``), every prompt the session prefills is
published at open and at join commit: its full pool pages (the store
takes one reference each, so they outlive the row) and its
pre-quantization K/V as a host seed slab. A joiner whose prompt shares a
published prefix seeds its private prefill cache with the slab, prefills
only the divergent tail (through B1 at that offset), and on the paged
pool maps the store's pages read-only into its table row (spilled nodes
are restored first); the positions past the last shared page boundary
are copied into the joiner's own page (copy on write). On the
contiguous cache reuse is seed-only. A preempted sharer copies its
shared pages to host memory with its own and releases them; the resume
re-shares them while the store still holds them, else swaps the copy
in. The store outlives the session: close detaches the pool, spilling
the store's pages to host memory.

On a sharded engine with a ``dp`` axis (``parallel/tp.py``) the rows
split into ``dp_shards`` contiguous blocks when the bucket divides the
axis: the sharded forward runs each block on its replica's shards, and
a paged session's pool partitions its pages into as many ranges
(``PagePool(dp_shards=)``), a row's pages, its parking page and its
joins', resumes' and copies' pages taken from its block's range first.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from ..models.quantize import quantize_kv_cache
from ..models.transformer import forward, logits_for
from ..obs.detect import observe_retired_tokens, observe_slice_tokens
from ..obs.metrics import enabled as _obs_enabled, observe_swap, swap_host_adjust
from ..runner import term
from ..ops.cuda_attention import cuda_prefill_attention
from ..ops.sampling import sample_token
from .backend import GenerationRequest, GenerationResult
from .paged_kv import PagePool, _paginate, quantize_chunks, scatter_pages
from .prefix import observe_hit
from .speculative import DraftSpec
from .torch_engine import (
    _PREFILL_H,
    BATCH_BUCKETS,
    DECODE_SLICE_STEPS,
    GEN_BUCKETS,
    JOIN_PREFILL_CHUNK_TOKENS,
    PREFILL_CHUNK,
    PROMPT_BUCKETS,
    _apply_stop,
    _bucket,
    _floor_bucket,
    _pow2_at_least,
    _prompt_alloc,
    _prompt_chunks,
    _spec_margin,
)

_SPEC_COUNTERS = ("rounds", "accepted", "drafted", "rejected")
_ATTR_KEYS = ("wall", "J", "J_low", "J_high")


def _leaf_map(fn, leaf):
    """``fn`` over a side-cache leaf: a tensor, or an int8 ``{"q","s"}``."""
    if isinstance(leaf, dict):
        return {k: fn(v) for k, v in leaf.items()}
    return fn(leaf)


def _leaf_nbytes(leaf) -> int:
    parts = leaf.values() if isinstance(leaf, dict) else (leaf,)
    return sum(t.numel() * t.element_size() for t in parts)


def _set_row(cache, r: int, row) -> None:
    """Write one row of a batch cache [L, B, ...] (or an int8 ``{"q",
    "s"}`` pair) in place from ``row`` [L, 1, ...], any device."""
    if isinstance(cache, dict):
        for key in cache:
            _set_row(cache[key], r, row[key])
        return
    cache[:, r].copy_(row[:, 0])


def _state_kv(st):
    """One prefill state's private K/V [L, 1, Hkv, T, D]: a solo row's
    own cache, or a grouped row's slice of its group's."""
    if "group" in st:
        g, gi = st["group"], st["gi"]
        return g["k"][:, gi : gi + 1], g["v"][:, gi : gi + 1]
    return st["k_cache"], st["v_cache"]


def _cut_lanes(leaf, d: int):
    """A K/V leaf (or an int8 ``{"q","s"}`` pair) with its head dim cut to
    ``d``: the JAX package's stacked pools pad it with zero lanes."""
    if isinstance(leaf, dict):
        return {k: (v[..., :d] if k == "q" else v) for k, v in leaf.items()}
    return leaf[..., :d]


def _row_slab(cache, r: int):
    """Host copy of row ``r`` of a batch cache, the batch dim kept
    singleton so that :func:`_set_row` restores it (a copy: on a CPU
    engine ``.cpu()`` would alias the live row)."""
    return _leaf_map(lambda t: t[:, r : r + 1].to("cpu", copy=True), cache)


class _Account:
    """A slice-attribution account: the wall seconds and modelled Joules
    (nominal and the coefficient box's corners) billed to one row."""

    __slots__ = ("attr_wall", "attr_J", "attr_J_low", "attr_J_high")

    def __init__(self) -> None:
        self.attr_wall = 0.0
        self.attr_J = 0.0
        self.attr_J_low = 0.0
        self.attr_J_high = 0.0

    def take_account(self, other: "_Account") -> None:
        for key in _Account.__slots__:
            setattr(self, key, getattr(self, key) + getattr(other, key))


class _Row(_Account):
    """Host-side record of one live session row. ``streamed`` is the
    egress cursor (tokens already handed out by ``stream_deltas``)."""

    __slots__ = (
        "request", "s_real", "generated", "budget", "t0", "t1", "t_decode0", "pages",
        "streamed", "attr_slices", "attr_wasted_J",
    )

    def __init__(self, request, s_real, first, budget, t0, t1, t_decode0, pages):
        super().__init__()
        self.request = request
        self.s_real = s_real
        self.generated: List[int] = [first]
        self.budget = budget  # decode-loop steps (max_new_tokens - 1)
        self.t0 = t0
        self.t1 = t1
        self.t_decode0 = t_decode0
        self.pages: List[int] = pages
        self.streamed = 0
        self.attr_slices = 0
        # waste this row caused that the wasted-energy ledger already
        # holds (its swap): informational, never added to attr_J
        self.attr_wasted_J = 0.0


class _PendingJoin(_Account):
    """One joiner between ``join_begin`` and ``join_commit``: the reserved
    slot (and pages, paged), the private contiguous cache its prompt
    chunks fill, and the cursor over those chunks. A preemption resume
    rides the same object (``resume`` set): a swap resume has no chunks
    (its KV comes back from host memory at commit), a recompute resume's
    chunks re-prefill the prompt and the generated tokens. In a
    speculating session with a model draft, ``draft_chunks`` prefill the
    draft's private cache (``draft_k``/``draft_v``, ``spec_draft_len``
    positions) over ``draft_ids`` after the target's chunks. With a
    shared-prefix hit, ``hit_tokens`` leading positions are seeded from
    the prefix store (the chunks cover only the tail) and the first
    ``shared_pages`` entries of ``pages`` are read-only mappings of the
    store's pool pages (one reference each)."""

    __slots__ = (
        "request", "slot", "ids", "chunks", "next_chunk",
        "k_cache", "v_cache", "presence", "logits", "pages", "prefill_s", "t0",
        "resume", "resume_mode", "draft_k", "draft_v", "draft_chunks", "draft_next",
        "draft_ids", "hit_tokens", "shared_pages",
    )

    def __init__(self, request, slot, ids, chunks, k_cache, v_cache, presence, pages):
        super().__init__()
        self.request = request
        self.slot = slot
        self.ids: List[int] = ids
        self.chunks: List[tuple] = chunks
        self.next_chunk = 0
        self.k_cache = k_cache
        self.v_cache = v_cache
        self.presence = presence
        self.logits = None
        self.pages: List[int] = pages
        self.prefill_s = 0.0  # the sum of chunk walls, not the interleaved span
        self.t0 = time.monotonic()
        self.resume: "Optional[PreemptedRow]" = None
        self.resume_mode: Optional[str] = None  # "swap" or "recompute"
        self.draft_k = None
        self.draft_v = None
        self.draft_chunks: List[tuple] = []
        self.draft_next = 0
        self.draft_ids: List[int] = ids
        self.hit_tokens = 0
        self.shared_pages = 0

    @property
    def total_chunks(self) -> int:
        return len(self.chunks) + len(self.draft_chunks)


class PreemptedRow(_Account):
    """Everything :meth:`SteppedDecodeSession.resume_begin` needs to
    continue a row that :meth:`SteppedDecodeSession.preempt` took out:
    the host copy of its control state (last token, generator state,
    presence row, offset, remaining budget), under ``policy="swap"`` its
    KV payload (a paged row's prompt pages, ``blob``, a ``PageSwapBlob``,
    and its side-cache columns, ``side_blob``; a contiguous row's cache
    slab, ``cache_blob``; a speculating row's draft-cache row and draft
    offset, ``draft_blob`` and ``draft_offset``), and its attribution
    account. A paged row's leading pages that it shares with the prefix
    store are copied into ``blob`` with its own and released; their ids
    (``shared_pages``) let the resume re-share them while the store still
    holds them, and swap the whole blob in when it does not. ``use_top_p``, ``use_rp``, ``paged`` and
    ``stacked`` describe the row and its layout for a migrate bundle
    (``serve/migrate.py``)."""

    __slots__ = (
        "request", "ids", "generated", "prompt_len", "offsets", "remaining",
        "gen_state", "presence", "streamed", "t0", "t1", "policy", "blob",
        "side_blob", "cache_blob", "draft_blob", "draft_offset", "n_own_pages",
        "shared_pages", "host_bytes", "discharged", "attr_slices", "attr_wasted_J",
        "use_top_p", "use_rp", "paged", "stacked",
    )

    def __init__(self, request, ids, generated, prompt_len) -> None:
        super().__init__()
        self.request = request
        self.ids: List[int] = list(ids)
        self.generated: List[int] = list(generated)
        self.prompt_len = prompt_len
        self.offsets = 0
        self.remaining = 0
        self.gen_state: Optional[torch.Tensor] = None
        self.presence: Optional[torch.Tensor] = None
        self.streamed = 0
        self.t0 = 0.0
        self.t1 = 0.0
        self.policy = "swap"
        self.blob = None
        self.side_blob = None
        self.cache_blob = None
        self.draft_blob = None
        self.draft_offset = 0
        self.n_own_pages = 0
        # leading page ids shared with the prefix store, released at
        # preempt and re-shared at resume while the store holds them
        self.shared_pages: List[int] = []
        self.use_top_p = False
        self.use_rp = False
        self.paged = False
        self.stacked = False
        self.host_bytes = 0
        self.discharged = False  # swap ledger already settled
        self.attr_slices = 0
        self.attr_wasted_J = 0.0


class SteppedDecodeSession:
    """One resumable batched decode (see the module docstring). ``rows[r]
    is None`` marks a free slot; free slots ride along done, as the batch
    path's pad rows do (a contiguous slot at its frozen offset over its
    own row, a paged one reading one parking page)."""

    def __init__(self, engine, model: str, top_k: int) -> None:
        self.engine = engine
        self.model = model
        self.top_k = top_k
        self.closed = False
        self.paged = bool(engine.paged_kv)
        self.pool: Optional[PagePool] = None
        # dp row sharding (a sharded engine's ``_dp_shards``): the rows
        # split into this many contiguous blocks, each a dp shard's, and a
        # paged session's pool into as many page ranges
        self.dp_shards = 1
        self.parking_pages: List[int] = []
        self.cache_len = 0  # the contiguous batch cache's positions a row
        # models whose weights this session keeps out of the LRU guard's
        # reach (set at the end of a successful open, released by close)
        self._session_pins: List[str] = []
        self.carry: Dict[str, Any] = {}
        self.rows: List[Optional[_Row]] = []
        # the active speculative config ({source, draft, k, dcfg, floor,
        # k0}) or None; spec_info is what retiring rows report, kept
        # through a fallback (spec_fallback)
        self.spec: Optional[Dict[str, Any]] = None
        self.spec_info: Optional[Dict[str, Any]] = None
        self.spec_fallback = False
        self.spec_draft_len = 0
        self.spec_margin = 0  # the contiguous rows' overshoot margin
        # host mirrors of the carry's cumulative per-row spec counters,
        # the adaptive policy's window of recent (accepted, drafted), and
        # each row's cross-model draft Joules billed as wasted
        self._spec_host: Dict[str, List[int]] = {}
        self._spec_recent: List[tuple] = []
        self._spec_draft_wasted: List[float] = []
        self.use_top_p = False
        # slot -> _PendingJoin: joiners mid-prefill (and resumes). A
        # reserved slot is neither free nor live: it rides along done.
        self._pending: Dict[int, _PendingJoin] = {}
        # streaming egress: while the scheduler has a streaming row live,
        # retiring rows buffer their unstreamed tails for stream_deltas
        self.stream_tokens = False
        self._stream_tail: List[tuple] = []
        # bytes and rows of this session's preemption victims parked in
        # host memory (the llm_swap_host_* gauges move through
        # _swap_account only, so they return to idle exactly)
        self._swap_bytes = 0
        self._swap_rows = 0
        # slice-attribution books: everything billed to this session's
        # rows, and the accounts of rows that left without retiring
        # (cancel, abort, close) — live + retired + dropped == totals
        self._attr_totals = dict.fromkeys(_ATTR_KEYS, 0.0)
        self._attr_dropped = dict.fromkeys(_ATTR_KEYS, 0.0)
        # the engine's shared prefix store (None when prefix_share is
        # off: every store path below guards on it). The session consults
        # and publishes to it but never owns it.
        self.store = getattr(engine, "prefix_store", None)

    # -- construction ---------------------------------------------------------
    @classmethod
    def open(
        cls,
        engine,
        requests: "list[GenerationRequest]",
        reserve_rows: Optional[int] = None,
        slice_steps: Optional[int] = None,
        spec_accept_floor: Optional[float] = None,
        spec_override: Optional[DraftSpec] = None,
    ) -> "SteppedDecodeSession":
        if not requests:
            raise ValueError("decode_open needs at least one request")
        models = {r.model for r in requests}
        if len(models) > 1:
            raise ValueError(f"one model per session, got {sorted(models)}")
        top_ks = {r.top_k for r in requests}
        if len(top_ks) > 1:
            raise ValueError(f"one top_k per session, got {sorted(top_ks)}")
        model = requests[0].model
        engine.load_model(model)
        self = cls(engine, model, requests[0].top_k)
        self.cfg = engine._models[model].cfg
        self.tok = engine._tokenizer_for(model)
        all_ids = [self.tok.encode(r.prompt) for r in requests]
        self.b_bucket = _bucket(max(len(requests), int(reserve_rows or 0)), BATCH_BUCKETS)
        self.g_bucket = _bucket(max(r.max_new_tokens for r in requests), GEN_BUCKETS)
        self.slice_bucket = max(1, int(slice_steps or DECODE_SLICE_STEPS))
        # before the caches are sized: the side caches carry the verify's
        # overshoot only when the session speculates
        self._init_spec(requests, all_ids, spec_accept_floor, spec_override)
        if self.paged:
            self._open_paged(requests, all_ids)
        else:
            self._open_contiguous(requests, all_ids)
        if self.spec is not None:
            if self.spec["draft"] is not None:
                self._open_draft(all_ids)
            else:
                self._open_ngram(all_ids)
        # registered last, so that a failed open leaks no pin
        self._session_pins = [self.model]
        if self.spec is not None and self.spec["draft"] is not None:
            self._session_pins.append(self.spec["draft"])
        for name in self._session_pins:
            engine._session_opened(name)
        return self

    def _init_spec(self, requests, all_ids, spec_accept_floor, spec_override) -> None:
        """Decide whether this session runs draft-verify: a DraftSpec
        applies (``spec_override``, else the engine's config), every
        opening row is eligible, the source is not blocked by its recent
        fallbacks (``_spec_source_blocked``, without an override) and,
        for a model draft, target and draft are resident together, share
        a vocabulary and the draft's contiguous cache fits its
        ``max_seq_len``. Any miss serves the session plain: configuring a
        draft never fails a request that plain decode would serve."""
        eng = self.engine
        spec = spec_override if spec_override is not None else eng._resolve_spec(self.model)
        if spec is None or not all(eng._spec_eligible(r) for r in requests):
            return
        floor = eng.spec_accept_floor if spec_accept_floor is None else float(spec_accept_floor)
        if spec_override is None and eng._spec_source_blocked(spec.source, spec.draft, floor):
            return  # the consult decays the memory: a later session re-probes
        margin = _spec_margin(spec.k)
        draft_len = max(_prompt_alloc(max(len(i), 1)) for i in all_ids) + self.g_bucket + margin
        dcfg = None
        if spec.draft is not None:
            eng.load_model(spec.draft)
            if self.model not in eng._models:  # the draft's load evicted the target
                eng.load_model(self.model)
            if self.model not in eng._models or spec.draft not in eng._models:
                warnings.warn(
                    f"speculative session: {self.model} and {spec.draft} cannot be "
                    "co-resident; serving plain"
                )
                return
            dcfg = eng._models[spec.draft].cfg
            if dcfg.vocab_size != self.cfg.vocab_size:
                warnings.warn(
                    f"speculative session: draft {spec.draft} vocab {dcfg.vocab_size} != "
                    f"target vocab {self.cfg.vocab_size}; serving plain"
                )
                return
            if draft_len > dcfg.max_seq_len:
                return
        # k0: the configured draft length, which sized every allocation
        # (side-cache overshoot, contiguous margin); the adaptive policy
        # moves "k" at or below it
        self.spec = {
            "source": spec.source, "draft": spec.draft, "k": spec.k, "dcfg": dcfg,
            "floor": floor, "k0": spec.k,
        }
        self.spec_info = {"draft_model": spec.draft, "k": spec.k, "source": spec.source}
        self.spec_draft_len = draft_len
        self.spec_margin = margin

    def _disable_spec_at_open(self) -> None:
        """Back out of speculation during open (the contiguous cache with
        its margin would pass ``max_seq_len``): the session never
        speculated, so no fallback is recorded."""
        self.spec = None
        self.spec_info = None
        self.spec_margin = 0
        self.spec_draft_len = 0

    def _open_draft(self, all_ids: "list[list[int]]") -> None:
        """Prefill the draft over every opening row's prompt into one
        contiguous batch cache (the draft never pages and never
        quantizes); padding rows replicate row 0."""
        eng = self.engine
        rows_k, rows_v = [], []
        for ids in all_ids:
            _, dk, dv = eng._run_prefill(self.spec["draft"], ids, self.spec_draft_len)
            rows_k.append(dk)
            rows_v.append(dv)
        pad = self.b_bucket - len(all_ids)
        self.carry["draft_k"] = torch.cat(rows_k + [rows_k[0]] * pad, dim=1)
        self.carry["draft_v"] = torch.cat(rows_v + [rows_v[0]] * pad, dim=1)
        offs = [len(i) for i in all_ids] + [len(all_ids[0])] * pad
        self.carry["draft_offsets"] = torch.tensor(offs, dtype=torch.long, device=eng.device)
        self._open_spec_counters()

    def _open_ngram(self, all_ids: "list[list[int]]") -> None:
        """The prompt-lookup source's state: one history row per slot,
        the prompt followed by the row's first token, of capacity
        ``spec_draft_len`` (every append a round can make fits)."""
        hist = torch.zeros((self.b_bucket, self.spec_draft_len), dtype=torch.long)
        full = [ids + [row.generated[0]] for ids, row in zip(all_ids, self.rows)]
        full += [full[0]] * (self.b_bucket - len(all_ids))
        for r, ids in enumerate(full):
            hist[r, : len(ids)] = torch.tensor(ids)
        dev = self.engine.device
        self.carry["ngram_hist"] = hist.to(dev)
        self.carry["ngram_len"] = torch.tensor([len(x) for x in full], dtype=torch.long, device=dev)
        self._open_spec_counters()

    def _open_spec_counters(self) -> None:
        for key in _SPEC_COUNTERS:
            self.carry["spec_" + key] = torch.zeros(
                (self.b_bucket,), dtype=torch.long, device=self.engine.device
            )
        self._spec_host = {key: [0] * self.b_bucket for key in _SPEC_COUNTERS}
        self._spec_draft_wasted = [0.0] * self.b_bucket

    def _set_ngram_row(self, r: int, full: "List[int]") -> None:
        """(Re)build slot ``r``'s n-gram history from its known tokens (a
        joiner's prompt and first token; a resumed row's prompt and
        generated tokens): the host holds them exactly."""
        hist = self.carry["ngram_hist"]
        full = full[: hist.shape[1]]
        hist[r].zero_()
        hist[r, : len(full)] = torch.tensor(full, dtype=hist.dtype, device=hist.device)
        self.carry["ngram_len"][r] = len(full)

    def _reset_spec_row(self, r: int) -> None:
        """Slot ``r``'s spec counters (carry and host mirror) and draft
        waste back to 0 for a new occupant."""
        for key in _SPEC_COUNTERS:
            self.carry["spec_" + key][r] = 0
            self._spec_host[key][r] = 0
        self._spec_draft_wasted[r] = 0.0

    def _open_contiguous(self, requests, all_ids) -> None:
        """Grouped prefill straight into one batch cache of ``cache_len``
        = the widest prompt allocation + ``g_bucket`` positions a row (an
        int8-KV engine quantizes it once); free slots copy row 0."""
        eng = self.engine
        rows_len = max(_prompt_alloc(max(len(i), 1)) for i in all_ids) + self.g_bucket
        # a speculating session's rows carry the rounds' overshoot margin
        # (a verify writes up to offset + k); where that would pass
        # max_seq_len the session serves plain
        self.cache_len = rows_len + self.spec_margin
        if self.spec is not None and self.cache_len > self.cfg.max_seq_len:
            self._disable_spec_at_open()
            self.cache_len = rows_len
        if self.cache_len > self.cfg.max_seq_len:
            raise ValueError(
                f"{self.model}: session cache {self.cache_len} exceeds "
                f"max_seq_len {self.cfg.max_seq_len}"
            )
        dp = eng._dp_shards()
        self.dp_shards = dp if dp > 1 and self.b_bucket % dp == 0 else 1
        states = eng._batch_states(requests, all_ids, cache_len=self.cache_len)
        published = [_state_kv(st) for st in states] if self.store is not None else []
        self.carry.update(eng._contiguous_state(requests, all_ids, states, self.b_bucket))
        self._seat_opening_rows(requests, states, [[] for _ in states])
        if self.store is not None:
            self.store.attach_pool(self.model, None)
            for ids, (k, v) in zip(all_ids, published):
                self._publish_prefix(ids, k, v, None)

    def _seat_opening_rows(self, requests, states, row_pages) -> None:
        self.use_top_p = any(r.top_p < 1.0 for r in requests)
        first = self.carry["tokens"].tolist()
        t_open = time.monotonic()
        self.rows = [
            _Row(r, st["s_real"], first[i], r.max_new_tokens - 1, st["t0"], st["t1"], t_open, pages)
            for i, (r, st, pages) in enumerate(zip(requests, states, row_pages))
        ] + [None] * (self.b_bucket - len(requests))

    def _open_paged(self, requests, all_ids) -> None:
        """Grouped prefill, then the prompts' K/V into a pool of
        ``pow2(2·(pages + 1))`` pages (×2 headroom, as the JAX session
        sizes it, and one parking page that free slots' table rows name)
        and a table ``pow2(2·max pages)`` wide; side caches of ``g_bucket``
        columns, plus ``k`` in spec mode."""
        eng = self.engine
        cfg = self.cfg
        for r, ids in zip(requests, all_ids):
            if len(ids) + r.max_new_tokens > cfg.max_seq_len:
                raise ValueError(
                    f"{self.model}: prompt {len(ids)} + generation "
                    f"{r.max_new_tokens} exceeds max_seq_len {cfg.max_seq_len}"
                )
        self.page_size = eng.page_size
        states = eng._batch_states(requests, all_ids)
        rows_pages = [self._pages_needed(st["s_real"]) for st in states]
        self.jmax = _pow2_at_least(2 * max(rows_pages))
        # one parking page a dp shard; dp engages when the bucket and the
        # page count divide it (the JAX package's rule)
        dp = eng._dp_shards()
        n_pages = _pow2_at_least(2 * (sum(rows_pages) + max(1, dp)), 4)
        self.dp_shards = dp if dp > 1 and self.b_bucket % dp == 0 and n_pages % dp == 0 else 1
        n_layers, n_kv_heads = eng._kv_dims(cfg)
        self.pool = PagePool.create(
            n_layers=n_layers, n_pages=n_pages,
            n_kv_heads=n_kv_heads, d_head=cfg.d_head, page_size=self.page_size,
            dtype=eng.dtype, quantized=bool(eng.kv_quantize), device=eng.device,
            dp_shards=self.dp_shards,
        )
        # free slots' table rows name a parking page in their own shard
        self.parking_pages = [self.pool.alloc(1, shard=d)[0] for d in range(self.dp_shards)]
        self.parking = self.parking_pages[0]
        table = [[self._parking_for(r)] * self.jmax for r in range(self.b_bucket)]
        row_pages = []
        for r, need in enumerate(rows_pages):
            pages = self.pool.alloc(need, shard=self._row_shard(r))
            row_pages.append(pages)
            table[r][:need] = pages
        asm = eng._assemble_rows(states, self.b_bucket, eng._row_field_specs(states))
        published = [_state_kv(st) for st in states] if self.store is not None else []
        eng._scatter_prompts(self.pool, states, asm.pop("_groups"), row_pages, self.parking)
        carry = eng._rows_state(requests, all_ids, states, asm, self.b_bucket)
        carry["pool"] = self.pool
        carry["table"] = torch.tensor(table, dtype=torch.int32, device=eng.device)
        side_cols = self.g_bucket + (self.spec["k"] if self.spec is not None else 0)
        carry["side_k"], carry["side_v"] = eng._side_caches(cfg, self.b_bucket, side_cols)
        self.carry.update(carry)
        self._seat_opening_rows(requests, states, row_pages)
        if self.store is not None:
            self.store.attach_pool(self.model, self.pool)
            for ids, (k, v), pages in zip(all_ids, published, row_pages):
                self._publish_prefix(ids, k, v, pages)

    def _row_shard(self, r: int) -> int:
        """The dp shard owning slot ``r``: slots split into ``dp_shards``
        contiguous blocks."""
        if self.dp_shards <= 1:
            return 0
        return min(r // (self.b_bucket // self.dp_shards), self.dp_shards - 1)

    def _parking_for(self, r: int) -> int:
        """The parking page in slot ``r``'s dp shard."""
        if not self.parking_pages:
            return self.parking
        return self.parking_pages[self._row_shard(r)]

    def _pages_needed(self, s_real: int, max_new_tokens: int = 0) -> int:
        """Pages one row pins: its prompt's only, whatever its budget
        (generated tokens, and a spec row's verify candidates, live in the
        side caches)."""
        return -(-max(s_real, 1) // self.page_size)

    # -- the shared prefix store ------------------------------------------------
    def _publish_prefix(self, ids, k_cache, v_cache, pages) -> None:
        """Publish a completed prompt prefill to the engine's store: its
        full pool pages (no layout writes a full prompt page again:
        generated tokens land in the side caches, or at positions past the
        prompt) and the seed slab a later sharer's tail prefill attends
        through. ``k_cache`` is the row's pre-quantization private cache
        [L, 1, Hkv, S, D]. The store takes one reference per adopted page,
        a joiner's divergent-tail pages included, so they outlive the
        row."""
        s_real = len(ids)
        if self.store is None or s_real < 2:
            return
        k_seed = k_cache[:, 0, :, :s_real]
        v_seed = v_cache[:, 0, :, :s_real]
        if self.paged:
            full = s_real // self.page_size
            self.store.publish(self.model, ids, k_seed, v_seed, pages[:full], self.pool)
        else:
            self.store.publish(self.model, ids, k_seed, v_seed, None, None)

    def _prefix_hit(self, ids: "List[int]") -> Optional[Dict[str, Any]]:
        """The longest usable store hit for ``ids`` as a plan, ``{"common",
        "hbm_lead", "restore_nodes", "restore_pages", "full_pages"}``, with
        ``common`` capped so that at least one tail token is computed (the
        prefill gives the first token's logits), or None. Side-effect
        free: ``can_join`` probes it, ``join_begin`` carries it out."""
        if self.store is None:
            return None
        common = min(self.store.match_len(self.model, ids), len(ids) - 1)
        if common <= 0:
            return None
        plan = {
            "common": common, "hbm_lead": [], "restore_nodes": [],
            "restore_pages": 0, "full_pages": 0,
        }
        if self.paged:
            plan.update(self.store.page_plan(self.model, ids, common))
        return plan

    @property
    def stacked(self) -> bool:
        """Whether the session is paged in the stacked-hybrid layout: every
        paged session of the port is."""
        return self.paged

    # -- state ----------------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for r in self.rows if r is not None)

    @property
    def free_slots(self) -> int:
        """Slots open to a joiner: not live and not reserved by one."""
        return sum(1 for r, row in enumerate(self.rows) if row is None and r not in self._pending)

    @property
    def pending_joins(self) -> int:
        return len(self._pending)

    def _free_slot(self) -> int:
        return next(r for r, row in enumerate(self.rows) if row is None and r not in self._pending)

    def debug_state(self) -> Dict[str, Any]:
        """A JSON-able snapshot: per-slot row state (age, tokens, budget,
        pages, spec counters), the spec config and totals, and the pool
        (paged) or the row cache's positions (contiguous)."""
        now = time.monotonic()
        spec_rows = self.spec_info is not None and bool(self._spec_host)
        state: Dict[str, Any] = {
            "model": self.model,
            "closed": self.closed,
            "paged": self.paged,
            "b_bucket": len(self.rows),
            "slice_steps": self.slice_bucket,
            "active": self.active,
            "free_slots": self.free_slots,
            "pending_joins": [
                {"slot": r, "chunk": pj.next_chunk, "chunks": pj.total_chunks,
                 "resume": pj.resume is not None}
                for r, pj in sorted(self._pending.items())
            ],
            "rows": [
                {
                    "slot": r,
                    "prompt_tokens": row.s_real,
                    "generated_tokens": len(row.generated),
                    "budget": row.budget,
                    "age_s": round(now - row.t0, 4),
                    "pages": len(row.pages),
                    **(
                        {
                            "spec_rounds": self._spec_host["rounds"][r],
                            "spec_accepted": self._spec_host["accepted"][r],
                            "verify_mode": self._verify_mode(),
                        }
                        if spec_rows else {}
                    ),
                }
                for r, row in enumerate(self.rows)
                if row is not None
            ],
        }
        if self.paged:
            state["pool"] = self.pool.debug_state()
        else:
            state["cache_len"] = self.cache_len
        mesh_info = getattr(self.engine, "mesh_info", None)
        info = mesh_info() if callable(mesh_info) else None
        if info is not None:
            # a sharded session: the mesh, and the KV bytes one shard holds
            state["mesh"] = dict(info)
            state["mesh"]["per_device_kv_bytes"] = self._per_device_kv_bytes()
            if self.paged:
                state["pool"]["per_device"] = {
                    "bytes": self._per_device_kv_bytes(pool_only=True),
                    "pages": self.pool.n_pages,
                    "occupancy": state["pool"]["occupancy"],
                }
        if self.store is not None:
            # the engine store's snapshot: what a joiner could hit now
            state["prefix_store"] = self.store.debug_state()
        if self.spec_info is not None:
            recent_acc = sum(a for a, _ in self._spec_recent)
            recent_drafted = sum(d for _, d in self._spec_recent)
            state["spec"] = {
                "active": self.spec is not None,
                "draft_model": self.spec_info["draft_model"],
                "source": self.spec_info["source"],
                "k": self.spec_info["k"],
                "fallback": self.spec_fallback,
                "verify_mode": self._verify_mode(),
                "scratch_bytes": self._spec_scratch_bytes(),
                "accept_floor": self.spec["floor"] if self.spec is not None else None,
                "acceptance_recent": (
                    round(recent_acc / recent_drafted, 4) if recent_drafted else None
                ),
                **{f"{key}_total": sum(self._spec_host.get(key, [])) for key in _SPEC_COUNTERS},
            }
        return state

    def _per_device_kv_bytes(self, pool_only: bool = False) -> int:
        """KV payload bytes one shard holds: each leaf's bytes over the
        attention shards folded into its layer axis (a draft's by the
        draft's own heads) and over the session's dp shards, whose rows
        (the pool: its page ranges) split the leaf. A model whose
        attention does not shard holds its whole cache on one shard."""
        eng, c = self.engine, self.carry
        keys = ["pool"] if self.paged else ["k_cache", "v_cache"]
        if not pool_only:
            keys += (["side_k", "side_v"] if self.paged else []) + ["draft_k", "draft_v"]
        total = 0
        for key in keys:
            leaf = c.get(key)
            if leaf is None:
                continue
            cfg = (self.spec or {}).get("dcfg") if key.startswith("draft") else self.cfg
            if cfg is None:
                continue
            shards = eng._kv_dims(cfg)[0] // cfg.n_layers
            nbytes = leaf.payload_nbytes() if key == "pool" else _leaf_nbytes(leaf)
            total += nbytes // shards // self.dp_shards
        return int(total)

    def _verify_mode(self) -> str:
        """``native`` on a paged session (the candidates live in the side
        caches' overshoot columns; the pool stays read-only), ``legacy`` on
        a contiguous one (the candidates land in the rows' own margin), as
        the JAX package names them."""
        return "native" if self.paged else "legacy"

    def _spec_scratch_bytes(self) -> int:
        """Bytes of verify scratch the session holds: a paged speculating
        session's side-cache overshoot columns (k0 of ``g_bucket + k0``); 0
        on a contiguous session, whose candidates land inside the rows'
        margin."""
        if not self.paged or self.spec is None:
            return 0
        total = 0
        for key in ("side_k", "side_v"):
            leaf = self.carry[key]
            for t in leaf.values() if isinstance(leaf, dict) else (leaf,):
                total += t.numel() * t.element_size() * self.spec["k0"] // t.shape[3]
        return total

    # -- stepping -------------------------------------------------------------
    def step(self, max_steps: Optional[int] = None) -> List[GenerationResult]:
        """Run one bounded slice (at most ``slice_bucket`` steps or rounds);
        returns the results of every row that retired in it (EOS or budget
        spent)."""
        if self.closed:
            raise RuntimeError("session is closed")
        live = [r for r, row in enumerate(self.rows) if row is not None]
        if not live:
            return []
        eng = self.engine
        tf = eng._models[self.model]
        n_real = min(max_steps or self.slice_bucket, self.slice_bucket)
        t1 = time.monotonic()
        if self.spec is not None:
            decode = eng._spec_batch_decode_step_fn(
                self.model, self.spec["draft"], self.spec["k"], self.slice_bucket,
                self.spec["source"], self.top_k, self.use_top_p, paged=self.paged,
            )
            draft = eng._models[self.spec["draft"]] if self.spec["draft"] is not None else None
            out, n_row = decode((tf, draft), self.carry, n_real)
        else:
            out, n_row = eng._decode_steps(tf, self.carry, n_real, self.top_k, self.tok.eos_id)
        out_host = out.tolist()
        n_row_host = n_row.tolist()
        done_host = self.carry["done"].tolist()
        slice_steps = self._spec_after_slice(live) if self.spec is not None else max(
            n_row_host[r] for r in live
        )
        t2 = time.monotonic()
        counts = {r: n_row_host[r] for r in live}
        slice_tokens = sum(counts.values())
        if _obs_enabled() and slice_tokens:
            # before retiring: rows that finish in this slice carry their
            # share of its wall and Joules into their close-out
            try:
                self._attr_slice(counts, t2 - t1, max(1, slice_steps))
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        retired: List[GenerationResult] = []
        for r in live:
            self.rows[r].generated.extend(out_host[r][: counts[r]])
            if done_host[r]:
                retired.append(self._retire(r, t2))
        # goodput: the slice stepped every bucket row; completed rows
        # credit their decode tokens at retirement
        observe_slice_tokens(slice_steps, len(self.rows))
        if slice_tokens:
            # a spec slice's steps are its rounds: one target forward each
            eng._observe_decode_window(
                t1, t2, slice_tokens, slice_steps, rows=len(live),
                path="paged" if self.paged else "contiguous",
            )
        return retired

    def _spec_after_slice(self, live: "List[int]") -> int:
        """Refresh the host mirrors of the cumulative spec counters, bill
        a cross-model draft's fully rejected rounds, publish the slice's
        deltas (``llm_spec_*``, one ``spec_round`` flight event) and run
        the adaptive policy. Returns the rounds this slice ran (the
        largest per-row delta: every live row rides every round).

        The policy: a window of the last 4 slices' (accepted, drafted),
        judged once it holds at least 2 slices and 2k drafts. Below the
        floor, k halves toward 1 (a shorter draft is accepted more
        often), and at k = 1 the session falls back to plain decode; at
        or above ``min(0.95, floor + 0.15)`` (the band keeps the two
        thresholds from oscillating) k doubles back toward k0, never past
        it. Every k emits the target's own tokens: k moves only the
        speed."""
        new = {key: self.carry["spec_" + key].tolist() for key in _SPEC_COUNTERS}
        prev = self._spec_host
        rounds_delta = [a - b for a, b in zip(new["rounds"], prev["rounds"])]
        rej_delta = [a - b for a, b in zip(new["rejected"], prev["rejected"])]
        acc_delta = sum(new["accepted"]) - sum(prev["accepted"])
        drafted_delta = sum(new["drafted"]) - sum(prev["drafted"])
        self._spec_host = new
        source, k = self.spec["source"], self.spec["k"]
        if source == "cross" and any(d > 0 for d in rej_delta):
            # a fully rejected round burned k forwards of another lane's
            # model for no emitted token: those Joules go to the
            # wasted-energy ledger, priced at the draft's live J/token
            # when the fleet's hook gives one (partly accepted rounds
            # bill nothing: their drafts became tokens)
            try:
                from ..obs.energy import charge_wasted

                hook = self.engine.spec_draft_jpt
                jpt = hook(self.spec["draft"]) if hook else None
                for r, d in enumerate(rej_delta):
                    if d > 0:
                        self._spec_draft_wasted[r] += charge_wasted(
                            "draft", tokens=float(d * k), jpt=jpt
                        )
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        slice_rounds = max([rounds_delta[r] for r in live] or [0])
        if _obs_enabled() and slice_rounds:
            try:
                from ..obs.flight import EV_SPEC_ROUND, FLIGHT, trace_attrs
                from ..obs.metrics import SPEC_VERIFY_NATIVE_C, observe_spec
                from ..obs.trace import TRACER

                observe_spec(
                    slice_rounds, acc_delta, drafted_delta, source=source,
                    rejected=sum(rej_delta) * k,
                )
                if self.paged:
                    SPEC_VERIFY_NATIVE_C.inc(slice_rounds)
                FLIGHT.emit(
                    EV_SPEC_ROUND, **trace_attrs(TRACER.current()),
                    model=self.model, draft=self.spec["draft"], source=source, k=k,
                    rounds=slice_rounds, accepted=acc_delta, drafted=drafted_delta,
                    acceptance=round(acc_delta / drafted_delta, 4) if drafted_delta else None,
                )
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        floor = self.spec["floor"]
        if floor > 0.0 and drafted_delta:
            self._spec_recent = (self._spec_recent + [(acc_delta, drafted_delta)])[-4:]
            win_acc = sum(a for a, _ in self._spec_recent)
            win_drafted = sum(d for _, d in self._spec_recent)
            if len(self._spec_recent) >= 2 and win_drafted >= 2 * k:
                measured = win_acc / win_drafted
                if measured < floor:
                    if k > 1:
                        self._spec_set_k(max(1, k // 2), measured)
                    else:
                        self._spec_fall_back(measured)
                elif k < self.spec["k0"] and measured >= min(0.95, floor + 0.15):
                    self._spec_set_k(min(self.spec["k0"], k * 2), measured)
        return slice_rounds

    def _spec_set_k(self, k_new: int, measured: float) -> None:
        """Move the session's draft length: the next slice takes the
        engine's step function for ``k_new`` (one per k, no allocation:
        the side caches and the contiguous margin were sized at k0), and
        the acceptance window restarts so that the new length earns its
        own evidence."""
        k_old = self.spec["k"]
        if k_new == k_old:
            return
        self.spec["k"] = k_new
        self.spec_info["k"] = k_new
        self._spec_recent = []
        direction = "down" if k_new < k_old else "up"
        source = self.spec["source"]
        term.log_warn(
            f"speculative session [{self.model}]: source {source} acceptance "
            f"{measured:.2f}; draft length k {k_old} -> {k_new} ({direction})"
        )
        if _obs_enabled():
            try:
                from ..obs.flight import EV_SPEC_K_ADAPT, FLIGHT
                from ..obs.metrics import SPEC_K_ADAPT_C

                SPEC_K_ADAPT_C.labels(source=source, direction=direction).inc()
                FLIGHT.emit(
                    EV_SPEC_K_ADAPT, model=self.model, source=source, k_from=k_old,
                    k_to=k_new, acceptance=round(measured, 4), floor=self.spec["floor"],
                )
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _spec_fall_back(self, measured: float) -> None:
        """Switch the session to plain decode mid-flight: drop the draft,
        n-gram and counter leaves from the carry (the row-control and
        target-KV leaves are the plain step's too, so tokens, offsets,
        budgets and done-masks carry over, and both emit the target's own
        tokens), keep ``spec_info`` and the host counters for the retiring
        rows' extras, and tell the engine's per-source memory."""
        for key in ("draft_k", "draft_v", "draft_offsets", "ngram_hist", "ngram_len"):
            self.carry.pop(key, None)
        for key in _SPEC_COUNTERS:
            self.carry.pop("spec_" + key, None)
        floor, source, draft = self.spec["floor"], self.spec["source"], self.spec["draft"]
        self.spec = None
        self.spec_fallback = True
        self._spec_recent = []
        self.engine._spec_source_feedback(source, draft, measured)
        term.log_warn(
            f"speculative session [{self.model}]: source {source} measured acceptance "
            f"{measured:.2f} < floor {floor:g}; falling back to plain decode"
        )
        if _obs_enabled():
            try:
                from ..obs.flight import EV_SPEC_FALLBACK, FLIGHT
                from ..obs.metrics import SPEC_FALLBACK_C

                SPEC_FALLBACK_C.labels(source=source).inc()
                FLIGHT.emit(
                    EV_SPEC_FALLBACK, model=self.model, source=source,
                    acceptance=round(measured, 4), floor=floor,
                )
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def _retire(self, r: int, t2: float) -> GenerationResult:
        row = self.rows[r]
        req = row.request
        generated = row.generated
        eos = self.tok.eos_id
        reason = "eos" if generated and generated[-1] == eos else "budget"
        if req.stop_at_eos and eos in generated:
            generated = generated[: generated.index(eos)]
        text = self.tok.decode(generated)
        if req.stop:
            generated, text = _apply_stop(generated, text, self.tok, req.stop)
        extras: Dict[str, Any] = {"retire_reason": reason, "stepped": True}
        if self.spec_info is not None and self._spec_host:
            # the row's own counters, frozen at their values before a
            # fallback to plain decode
            extras["spec"] = {
                **{key: self._spec_host[key][r] for key in _SPEC_COUNTERS},
                "k": self.spec_info["k"],
                "draft_model": self.spec_info["draft_model"],
                "source": self.spec_info["source"],
                "fallback": self.spec_fallback,
            }
            if self._spec_draft_wasted[r]:
                # another lane's model's Joules burned in this row's fully
                # rejected rounds (already in the wasted-energy ledger)
                extras["spec"]["draft_wasted_J"] = round(self._spec_draft_wasted[r], 6)
        if _obs_enabled() and (row.attr_slices or row.attr_wall):
            try:
                self._close_out_energy(r, row, extras, len(generated))
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        result = GenerationResult(
            request=req,
            tokens=generated,
            text=text,
            prompt_tokens=row.s_real,
            generated_tokens=len(generated),
            prefill_s=row.t1 - row.t0,
            decode_s=t2 - row.t_decode0,
            total_s=t2 - row.t0,
            extras=extras,
        )
        # the decode-loop tokens of a completed row were useful work (the
        # first token came from prefill)
        observe_retired_tokens(max(0, len(row.generated) - 1))
        if self.stream_tokens and row.streamed < len(generated):
            # the unstreamed tail, after the cuts, so that the deltas
            # concatenate to the final tokens
            tail = generated[row.streamed :]
            self._stream_tail.append((req, tail, self.tok.decode(tail)))
        self._vacate(r)
        return result

    def _vacate(self, r: int) -> None:
        """Take slot ``r`` out of the decode: done with no budget (its
        offset frozen), greedy (a free slot rides along without drawing
        from anyone's generator); a paged slot's table row parked before
        its pages return to the pool."""
        c = self.carry
        c["done"][r] = True
        c["remaining"][r] = 0
        c["gens"][r] = None
        c["knobs"]["temperature"][r] = 0.0
        c["knobs"]["top_p"][r] = 1.0
        c["knobs"]["repeat_penalty"][r] = 1.0
        row = self.rows[r]
        if self.paged:
            c["table"][r] = self._parking_for(r)
            if row.pages:
                self.pool.free(row.pages)
                row.pages = []
        self.rows[r] = None

    # -- slice energy and wall attribution --------------------------------------
    def _bill(self, account: _Account, wall: float, est, share: float = 1.0) -> None:
        j = jl = jh = 0.0
        if est is not None:
            j, jl, jh = est["J"], est["J_low"], est["J_high"]
        account.attr_wall += wall * share
        account.attr_J += j * share
        account.attr_J_low += jl * share
        account.attr_J_high += jh * share

    def _attr_slice(self, counts: "Dict[int, int]", wall: float, steps: int) -> None:
        """Split one decode slice's wall and modelled Joules over its rows
        by token share: a row that sampled ``cnt`` of the slice's tokens
        owns ``cnt / tokens`` of both. The model prices the slice at each
        row's own context (``slice_window_stats``)."""
        slice_tokens = sum(counts.values())
        if not slice_tokens or wall <= 0:
            return
        pairs = [
            (self.rows[r].s_real + len(self.rows[r].generated), cnt) for r, cnt in counts.items()
        ]
        est = self.engine._slice_energy(self.model, self.cfg, pairs, wall, steps)
        self._book_total(wall, est)
        for r, cnt in counts.items():
            if cnt:
                row = self.rows[r]
                self._bill(row, wall, est, cnt / slice_tokens)
                row.attr_slices += 1

    def _attr_chunk(self, pending: _PendingJoin, ctx: int, new: int, wall: float) -> None:
        """Bill one join-prefill chunk to its joiner (the rows in flight
        stall for it, but the work is the joiner's)."""
        if wall <= 0 or new <= 0:
            return
        est = self.engine._slice_energy(self.model, self.cfg, [(ctx, new)], wall, 1)
        self._book_total(wall, est)
        self._bill(pending, wall, est)

    def _book_total(self, wall: float, est) -> None:
        tot = self._attr_totals
        tot["wall"] += wall
        if est is not None:
            tot["J"] += est["J"]
            tot["J_low"] += est["J_low"]
            tot["J_high"] += est["J_high"]

    def _attr_drop(self, account: _Account) -> None:
        """Move a departing account (cancelled row, aborted joiner, row
        abandoned at close) into the dropped books."""
        d = self._attr_dropped
        d["wall"] += account.attr_wall
        d["J"] += account.attr_J
        d["J_low"] += account.attr_J_low
        d["J_high"] += account.attr_J_high

    def _close_out_energy(self, r: int, row: _Row, extras: Dict[str, Any], gen_tokens: int) -> None:
        """Stamp the retiring row's account into ``extras["energy_model"]``
        (``window="slice"``), record it in the ``llm_request_*`` families
        and refresh the engine's live J/token."""
        from ..obs.energy import observe_estimate

        j, jl, jh = row.attr_J, row.attr_J_low, row.attr_J_high
        per = (lambda x: x / gen_tokens) if gen_tokens else (lambda x: 0.0)
        wasted = row.attr_wasted_J + (self._spec_draft_wasted[r] if self._spec_draft_wasted else 0.0)
        extras["energy_model"] = {
            "J": round(j, 9),
            "J_low": round(jl, 9),
            "J_high": round(jh, 9),
            "J_per_token": round(per(j), 9),
            "J_per_token_low": round(per(jl), 9),
            "J_per_token_high": round(per(jh), 9),
            "wall_attr_s": round(row.attr_wall, 9),
            "slices": row.attr_slices,
            "window": "slice",
            **({"wasted_J": round(wasted, 9)} if wasted else {}),
        }
        observe_estimate({
            "J": j,
            "J_per_token": per(j),
            "J_per_token_low": per(jl) if gen_tokens else None,
            "J_per_token_high": per(jh) if gen_tokens else None,
        })
        if per(j) > 0:
            self.engine.last_joules_per_token = per(j)
            self.engine.last_joules_per_token_by_model[self.model] = per(j)

    # -- streaming egress and cancellation ---------------------------------------
    def stream_deltas(self) -> List[tuple]:
        """Each row's tokens since the previous call, as ``(request,
        tokens, text)``; rows that retired since then give their buffered
        tail, so a drained stream's deltas concatenate to the final token
        list (a stop string cuts retroactively: the final text is the
        authority there). A live row that asked ``stop_at_eos`` never
        streams its EOS."""
        out: List[tuple] = list(self._stream_tail)
        self._stream_tail.clear()
        eos = self.tok.eos_id
        for row in self.rows:
            if row is None or len(row.generated) <= row.streamed:
                continue
            new = row.generated[row.streamed :]
            row.streamed = len(row.generated)
            if row.request.stop_at_eos and eos in new:
                new = new[: new.index(eos)]
            if new:
                out.append((row.request, new, self.tok.decode(new)))
        return out

    def cancel(self, request: GenerationRequest) -> bool:
        """Retire ``request``'s live row now without completing it: its
        pages go back to the pool and its partial stream is dropped.
        False when the request has no live row (it already retired)."""
        for r, row in enumerate(self.rows):
            if row is not None and row.request is request:
                self._attr_drop(row)
                self._vacate(r)
                return True
        return False

    # -- preemption --------------------------------------------------------------
    def _swap_account(self, d_bytes: int, d_rows: int) -> None:
        self._swap_bytes = max(0, self._swap_bytes + d_bytes)
        self._swap_rows = max(0, self._swap_rows + d_rows)
        swap_host_adjust(d_bytes, rows=d_rows)

    def preempt(self, request: GenerationRequest, policy: str = "swap") -> "Optional[PreemptedRow]":
        """Take ``request``'s live row out now, like :meth:`cancel`, but
        keep what :meth:`resume_begin` needs to continue it with an
        unchanged token stream: the row's control state (last token,
        generator state, presence row, offset, budget) in host memory,
        and under ``policy="swap"`` its K/V too (a contiguous row's cache
        slab; a paged row's prompt pages, ``PagePool.swap_out``, and its
        side-cache columns). ``policy="recompute"`` keeps no K/V: the
        resume re-prefills the prompt and the generated tokens. Fenced:
        the copies have landed when it returns.

        A speculating row parks with its draft-cache row and draft offset
        under ``swap``; under ``recompute`` the resume re-prefills the
        draft too; an n-gram row's history is rebuilt from its tokens. Its
        generator advances once a round, so the resumed stream is the
        uninterrupted one.

        A paged row's leading pages shared with the prefix store (and
        other readers) are copied out with its own and released:
        ``pr.shared_pages`` keeps their ids, which the resume re-shares
        while the store still holds them, and swaps in from the copy
        when it does not.

        Returns None, and leaves the row running, when it cannot: no live
        row, an unknown policy, ``recompute`` on a paged session (it
        keeps the generated K/V in its side caches; swap is its policy,
        as in the JAX package), a paged row with shared pages past its
        leading run, or a re-prefill that would not fit the session's
        cache (or the draft's)."""
        if self.closed or policy not in ("swap", "recompute"):
            return None
        r = next((i for i, row in enumerate(self.rows)
                  if row is not None and row.request is request), None)
        if r is None:
            return None
        row = self.rows[r]
        draft_row = self.spec is not None and self.spec["draft"] is not None
        if policy == "recompute":
            need = _prompt_alloc(self.s_prefilled(row))
            if self.paged or need > self.cache_len or (draft_row and need > self.spec_draft_len):
                return None
        c = self.carry
        shared_n = 0
        if self.paged:
            while shared_n < len(row.pages) and self.pool.refcount(row.pages[shared_n]) > 1:
                shared_n += 1
            if any(self.pool.refcount(p) > 1 for p in row.pages[shared_n:]):
                return None  # shared pages past the leading run: keep it running
        pr = PreemptedRow(request, self.tok.encode(request.prompt), row.generated, row.s_real)
        pr.policy = policy
        pr.use_top_p = request.top_p < 1.0
        pr.use_rp = request.repeat_penalty != 1.0
        pr.paged = pr.stacked = self.paged
        pr.offsets = int(c["offsets"][r])
        pr.remaining = int(c["remaining"][r])
        gen = c["gens"][r]
        pr.gen_state = gen.get_state() if gen is not None else None
        if c["presence"] is not None and request.repeat_penalty != 1.0:
            pr.presence = c["presence"][r].to("cpu", copy=True)
        pr.streamed = row.streamed
        pr.t0, pr.t1 = row.t0, row.t1
        host_bytes = 0
        if draft_row and policy == "swap":
            pr.draft_blob = (_row_slab(c["draft_k"], r), _row_slab(c["draft_v"], r))
            pr.draft_offset = int(c["draft_offsets"][r])
            host_bytes += sum(_leaf_nbytes(x) for x in pr.draft_blob)
        if self.paged:
            pr.side_blob = tuple(
                # copies (on a CPU engine .cpu() would alias the live slot)
                _leaf_map(lambda t: t[:, r].to("cpu", copy=True), c[key])
                for key in ("side_k", "side_v")
            )
            pr.n_own_pages = len(row.pages) - shared_n
            pr.shared_pages = row.pages[:shared_n]
            # the row is untouched until its pages have left: a copy that
            # raises leaves it live and decoding as it was. The shared run
            # is copied too, so that the row resumes (and exports) after
            # the store has spilled or dropped it.
            if row.pages:
                pr.blob = self.pool.copy_out(row.pages)
                self.pool.free(row.pages)  # this row's references only
                observe_swap("out", pr.blob.nbytes)
                host_bytes += pr.blob.nbytes
            row.pages = []
            c["table"][r] = self._parking_for(r)
            side_bytes = sum(_leaf_nbytes(x) for x in pr.side_blob)
            observe_swap("out", side_bytes)
            host_bytes += side_bytes
        elif policy == "swap":
            pr.cache_blob = (_row_slab(c["k_cache"], r), _row_slab(c["v_cache"], r))
            cache_bytes = sum(_leaf_nbytes(x) for x in pr.cache_blob)
            observe_swap("out", cache_bytes)
            host_bytes += cache_bytes
        pr.take_account(row)
        pr.attr_slices = row.attr_slices
        pr.attr_wasted_J = row.attr_wasted_J
        pr.host_bytes = host_bytes
        if host_bytes:
            self._swap_account(host_bytes, 1)
        self._vacate(r)
        return pr

    @staticmethod
    def s_prefilled(row_or_pr) -> int:
        """Positions of K/V a row has made: prompt + generated, less the
        last token (sampled, not yet fed through the model). What a
        recompute resume re-prefills."""
        if isinstance(row_or_pr, PreemptedRow):
            return len(row_or_pr.ids) + len(row_or_pr.generated) - 1
        return row_or_pr.s_real + len(row_or_pr.generated) - 1

    def _resume_plan(self, pr: PreemptedRow) -> Optional[Dict[str, Any]]:
        """How ``pr`` can re-enter this session now: ``{"mode": "swap" |
        "recompute", "need": pool pages}``, or None when it cannot (another
        model or ``top_k``, a paged victim without its pages, a swap slab
        of another row width, a re-prefill that no longer fits; in a
        speculating session a row that may not speculate, or whose
        history and budget, or whose draft re-prefill, would not fit the
        draft cache). Side-effect free."""
        if pr.request.model != self.model or pr.request.top_k != self.top_k:
            return None
        if self.spec is not None:
            # the resumed row speculates with this session's config
            if not self.engine._spec_eligible(pr.request):
                return None
            if self.s_prefilled(pr) + pr.remaining + 1 + self.spec_margin > self.spec_draft_len:
                return None
            if self.spec["draft"] is not None and self._draft_blob(pr) is None and (
                _prompt_alloc(self.s_prefilled(pr)) > self.spec_draft_len
            ):
                return None
        if self.paged:
            return self._paged_resume_plan(pr)
        if pr.cache_blob is not None:
            k = pr.cache_blob[0]
            width = (k["q"] if isinstance(k, dict) else k).shape[3]
            return {"mode": "swap", "need": 0} if width == self.cache_len else None
        if _prompt_alloc(self.s_prefilled(pr)) > self.cache_len:
            return None
        return {"mode": "recompute", "need": 0}

    def _paged_resume_plan(self, pr: PreemptedRow) -> Optional[Dict[str, Any]]:
        """A swap resume into this paged session: the blob and side-cache
        columns must fit its layout (a row from another session, or from
        another replica's bundle, may not), and a row that released pages
        shared with the prefix store re-shares them while they are still
        the store's leading device-resident run for its prompt. Once the
        store has moved on, the stacked layout cannot re-prefill (the
        generated K/V live in the side caches), so the whole prompt comes
        back from the blob, which holds the shared run too."""
        if pr.policy != "swap" or not self._adopt_layout(pr) or pr.side_blob is None:
            return None
        if pr.blob is None and pr.n_own_pages:
            return None
        if pr.blob is not None and (
            pr.blob.page_size != self.page_size or pr.blob.quantized != self.pool.quantized
        ):
            return None
        if len(pr.shared_pages) + pr.n_own_pages > self.jmax:
            return None
        # the generated positions so far and to come fit the side columns
        if pr.offsets - pr.prompt_len + pr.remaining > self.g_bucket:
            return None
        for key, blob in zip(("side_k", "side_v"), pr.side_blob):
            want = self.carry[key]
            if isinstance(want, dict) != isinstance(blob, dict):
                return None
            pairs = zip(want.values(), blob.values()) if isinstance(want, dict) else [(want, blob)]
            for w, b in pairs:
                if b.dtype != w.dtype or b.dim() != w.dim() - 1:
                    return None
                if b.shape[:2] != w.shape[:1] + w.shape[2:3] or b.shape[3:] != w.shape[4:]:
                    return None
                if b.shape[2] > w.shape[3]:
                    return None
        if not pr.shared_pages:
            return {"mode": "swap", "need": pr.n_own_pages, "reshare": False}
        if self.store is not None:
            held = self.store.hbm_run(self.model, pr.ids)[: len(pr.shared_pages)]
            if held == list(pr.shared_pages) and all(self.pool.refcount(p) >= 1 for p in held):
                return {"mode": "swap", "need": pr.n_own_pages, "reshare": True}
        need = len(pr.shared_pages) + pr.n_own_pages
        if pr.blob is None or pr.blob.n_pages != need:
            return None
        return {"mode": "swap", "need": need, "reshare": False}

    def _adopt_layout(self, pr: PreemptedRow) -> bool:
        """Bring a row imported from another engine's bundle to this
        session's layout, on ``pr`` itself (once; a row of this layout is
        left as it is). The JAX package's stacked pools pad the head dim
        to 128 lanes: the padding (zeros) is cut. Its unstacked paged rows
        keep the generated positions in their pages: the prompt's pages
        stay the blob and the generated positions become side-cache
        columns. False where no such mapping exists (a contiguous row's
        cache slab: this is a paged session)."""
        if pr.cache_blob is not None:
            return False
        d = self.cfg.d_head
        if pr.blob is not None:
            pr.blob.k_chunks = _cut_lanes(pr.blob.k_chunks, d)
            pr.blob.v_chunks = _cut_lanes(pr.blob.v_chunks, d)
        if pr.side_blob is not None:
            pr.side_blob = tuple(_cut_lanes(x, d) for x in pr.side_blob)
        if pr.stacked or pr.blob is None:
            return True
        # unstacked: pages hold the prompt and the generated positions
        page = self.page_size
        n_prompt = -(-max(pr.prompt_len, 1) // page)
        if pr.blob.n_pages < n_prompt or pr.offsets > pr.blob.n_pages * page:
            return False

        def positions(chunks):  # [N, L, Hkv, page, ...] -> [L, Hkv, N·page, ...]
            n, l, h = chunks.shape[:3]
            flat = chunks.permute(1, 2, 0, *range(3, chunks.dim()))
            return flat.reshape(l, h, n * page, *chunks.shape[4:])

        side = []
        for chunks in (pr.blob.k_chunks, pr.blob.v_chunks):
            side.append(_leaf_map(
                lambda c: positions(c)[:, :, pr.prompt_len : pr.offsets].contiguous(), chunks
            ))
        prompt_k = _leaf_map(lambda c: c[:n_prompt].contiguous(), pr.blob.k_chunks)
        prompt_v = _leaf_map(lambda c: c[:n_prompt].contiguous(), pr.blob.v_chunks)
        pr.blob = dataclasses.replace(
            pr.blob, k_chunks=prompt_k, v_chunks=prompt_v, n_pages=n_prompt,
            nbytes=_leaf_nbytes(prompt_k) + _leaf_nbytes(prompt_v),
        )
        pr.side_blob = tuple(side)
        pr.n_own_pages = n_prompt
        pr.stacked = True
        return True

    def _draft_blob(self, pr: PreemptedRow):
        """``pr``'s draft-cache slab when this session can seat it (the
        same draft cache width), else None: its draft re-prefills."""
        if pr.draft_blob is None or self.spec is None or self.spec["draft"] is None:
            return None
        k = pr.draft_blob[0]
        return pr.draft_blob if k.shape[3] == self.spec_draft_len else None

    def can_resume(self, pr: PreemptedRow) -> bool:
        """Whether ``pr`` fits back now: a free slot, a plan, and for a
        paged session its pages free. Side-effect free."""
        if self.closed or self.free_slots == 0:
            return False
        plan = self._resume_plan(pr)
        return plan is not None and (not self.paged or plan["need"] <= self.pool.free_pages)

    def resume_begin(self, pr: PreemptedRow, chunk_tokens: Optional[int] = None) -> _PendingJoin:
        """Start re-seating ``pr`` through the join machinery: reserve a
        free slot (and its pages). A swap resume has no chunks: its first
        :meth:`join_step` is done and :meth:`join_commit` brings its K/V
        back from host memory. A recompute resume splits the re-prefill of
        prompt + generated tokens into chunks of ``chunk_tokens`` (as a
        joiner's), which interleave with decode slices. In a speculating
        session a row without a draft slab this session can seat
        re-prefills the draft over the same tokens in chunks after those."""
        if not self.can_resume(pr):
            raise RuntimeError("preempted row cannot resume in this session")
        plan = self._resume_plan(pr)
        r = self._free_slot()
        if plan["mode"] == "swap":
            pages = []
            shared = pr.shared_pages if plan.get("reshare") else []
            if self.paged:
                own = self.pool.alloc(plan["need"], shard=self._row_shard(r))
                if shared:
                    self.pool.share(shared)
                    self.store.touch(self.model, pr.ids)
                pages = list(shared) + own
            pending = _PendingJoin(pr.request, r, pr.ids, [], None, None, pr.presence, pages)
            pending.shared_pages = len(shared)
        else:
            ids = pr.ids + pr.generated[:-1]
            chunks = self._join_chunks(ids, chunk_tokens)
            k_cache, v_cache = self.engine._models[self.model].init_cache(
                1, self.cache_len, dtype=self.engine.dtype
            )
            pending = _PendingJoin(pr.request, r, ids, chunks, k_cache, v_cache, pr.presence, [])
        pending.resume = pr
        pending.resume_mode = plan["mode"]
        if self.spec is not None and self.spec["draft"] is not None and self._draft_blob(pr) is None:
            self._begin_draft_prefill(pending, pr.ids + pr.generated[:-1], chunk_tokens)
        self._pending[r] = pending
        return pending

    def _begin_draft_prefill(self, pending: _PendingJoin, ids: "List[int]", chunk_tokens) -> None:
        """The pending row's private draft cache (``spec_draft_len``
        positions) and its chunks over ``ids``, run by :meth:`join_step`
        after the target's."""
        eng = self.engine
        pending.draft_k, pending.draft_v = eng._models[self.spec["draft"]].init_cache(
            1, self.spec_draft_len, dtype=eng.dtype
        )
        pending.draft_ids = ids
        pending.draft_chunks = self._join_chunks(ids, chunk_tokens, self.spec_draft_len)

    def resume_discard(self, pr: PreemptedRow) -> None:
        """Drop a parked row for good (its ticket was cancelled or its
        deadline passed): settle the swap ledger. Idempotent."""
        if pr.discharged:
            return
        pr.discharged = True
        if pr.host_bytes and not self.closed:
            self._swap_account(-pr.host_bytes, -1)
        pr.host_bytes = 0

    def _commit_resume(self, pending: _PendingJoin) -> int:
        """Finish a resume: the K/V back (a swap from host memory: the
        pages and side-cache columns, or the contiguous row's slab; a
        recompute from its re-prefilled private cache, installed as a
        joiner's), then the row re-seated with its captured state (same
        last token, generator state, presence, offset and budget), so its
        stream continues as if it had never left. Fenced."""
        pr = pending.resume
        r = pending.slot
        del self._pending[r]
        eng = self.engine
        c = self.carry
        if pending.resume_mode == "recompute":
            self._install_contiguous_row(r, pending)
        elif self.paged:
            if pr.blob is not None:
                # a re-shared run is on the device already: the rest
                skip = pending.shared_pages
                blob = pr.blob
                if skip:
                    k, v = (_leaf_map(lambda t: t[skip:], x) for x in (blob.k_chunks, blob.v_chunks))
                    blob = dataclasses.replace(
                        blob, k_chunks=k, v_chunks=v, n_pages=blob.n_pages - skip,
                        nbytes=_leaf_nbytes(k) + _leaf_nbytes(v),
                    )
                self.pool.swap_in(blob, pages=pending.pages[skip:])
            for key, blob in zip(("side_k", "side_v"), pr.side_blob):
                # a row from a narrower session (or an unstacked layout)
                # fills the first columns; the rest start clean
                def put(side, part):
                    side[:, r].zero_()
                    side[:, r, :, : part.shape[2]] = part.to(eng.device)

                if isinstance(blob, dict):
                    for name in blob:
                        put(c[key][name], blob[name])
                else:
                    put(c[key], blob)
            observe_swap("in", sum(_leaf_nbytes(x) for x in pr.side_blob))
            self._set_table_row(r, pending.pages)
        else:
            for key, blob in zip(("k_cache", "v_cache"), pr.cache_blob):
                _set_row(c[key], r, blob)
            observe_swap("in", sum(_leaf_nbytes(x) for x in pr.cache_blob))
        if self.spec is not None:
            # the row's draft-source state: its draft-cache row (the
            # parked slab, or the re-prefilled private cache), or its
            # n-gram history rebuilt from its tokens; counters from 0
            if self.spec["draft"] is None:
                self._set_ngram_row(r, pr.ids + pr.generated)
            elif pending.draft_k is not None:
                self._install_draft_row(r, pending.draft_k, pending.draft_v, len(pending.draft_ids))
            else:
                self._install_draft_row(r, *pr.draft_blob, pr.draft_offset)
            self._reset_spec_row(r)
        gen = None
        if pr.gen_state is not None:
            gen = torch.Generator(device=eng.device)
            gen.set_state(pr.gen_state)
        if pr.host_bytes:
            self._swap_account(-pr.host_bytes, -1)
            pr.host_bytes = 0
        pr.discharged = True
        self._seat_row(
            pr.request, r, first_token=pr.generated[-1], gen=gen, presence_row=pr.presence,
            offsets=pr.offsets, prompt_len=pr.prompt_len, remaining=pr.remaining,
            pages=pending.pages, t0=pr.t0, t1=pr.t1, generated=pr.generated,
            streamed=pr.streamed,
        )
        row = self.rows[r]
        # the parked account, and what the re-prefill's chunks billed
        row.take_account(pr)
        row.take_account(pending)
        row.attr_slices = pr.attr_slices
        row.attr_wasted_J = pr.attr_wasted_J
        eng._sync()
        return r

    # -- admission -----------------------------------------------------------------
    def can_join(self, request: GenerationRequest) -> bool:
        """Whether ``request`` fits this session's fixed shapes and free
        capacity now: its model and ``top_k``, a free slot, and then
        contiguous: its prompt allocation + generation bucket within the
        row cache (``cache_len`` less a speculating session's margin);
        paged: a budget the side caches hold (``max_new_tokens - 1 <=
        g_bucket``), no more pages than a table row names (``jmax``) and
        that many free pages. A speculating session admits a joiner that
        may speculate (``_spec_eligible``) and whose prompt allocation,
        generation bucket and margin fit the draft cache
        (``spec_draft_len``): it inherits the session's draft config.
        With a prefix-store hit, pages mapped from the store are billed
        once, to the store: only the divergent tail's pages (and the pages
        that restoring spilled nodes takes) come off the free list; where
        a restore would not fit, only the resident leading run counts.
        Side-effect free: the scheduler probes before paying a prefill."""
        if self.closed or self.free_slots == 0:
            return False
        if request.model != self.model or request.top_k != self.top_k:
            return False
        ids = self.tok.encode(request.prompt)
        n_ids = len(ids)
        if n_ids == 0 or n_ids + request.max_new_tokens > self.cfg.max_seq_len:
            return False
        need = _prompt_alloc(n_ids) + _bucket(request.max_new_tokens, GEN_BUCKETS)
        if self.spec is not None and (
            not self.engine._spec_eligible(request)
            or need + self.spec_margin > self.spec_draft_len
        ):
            return False
        if not self.paged:
            return need <= self.cache_len - self.spec_margin
        if request.max_new_tokens - 1 > self.g_bucket:
            return False
        need = self._pages_needed(n_ids)
        if need > self.jmax:
            return False
        hit = self._prefix_hit(ids)
        free = self.pool.free_pages
        if hit is None:
            return need <= free
        if need - hit["full_pages"] + hit["restore_pages"] <= free:
            return True
        return need - len(hit["hbm_lead"]) <= free  # the resident run only

    def join(self, request: GenerationRequest) -> int:
        """Admit ``request`` into a free slot, its whole prompt prefilled
        now (one chunk, as the solo path prefills it); it decodes from the
        next slice. Returns the slot. Built on the resumable protocol, so
        the two cannot drift; a failed prefill leaves the slot free."""
        pending = self.join_begin(request, chunk_tokens=PREFILL_CHUNK)
        try:
            while not self.join_step(pending):
                pass
            return self.join_commit(pending)
        except BaseException:
            self.join_abort(pending)
            raise

    def _join_chunks(
        self, ids: "List[int]", chunk_tokens: Optional[int], limit: Optional[int] = None
    ) -> "List[tuple]":
        """A joiner's (or a recompute resume's) prefill chunks of
        ``chunk_tokens`` (default JOIN_PREFILL_CHUNK_TOKENS, floored to a
        prompt bucket). Into a cache of ``limit`` positions (the
        contiguous row cache by default, or a draft cache), where the
        budgeted chunking's bucket rounding would overshoot it, the
        standard chunks instead (``can_join`` guarantees that they fit)."""
        if limit is None and not self.paged:
            limit = self.cache_len
        chunk = _floor_bucket(int(chunk_tokens or JOIN_PREFILL_CHUNK_TOKENS), PROMPT_BUCKETS)
        chunks = _prompt_chunks(len(ids), chunk)
        if limit is not None and chunks[-1][0] + chunks[-1][1] > limit:
            chunks = _prompt_chunks(len(ids))
            if chunks[-1][0] + chunks[-1][1] > limit:
                raise RuntimeError("the re-prefill does not fit the session cache")
        return chunks

    def join_begin(self, request: GenerationRequest, chunk_tokens: Optional[int] = None) -> _PendingJoin:
        """Start a resumable join: reserve a free slot (and, paged, the
        row's pages, so that other joiners cannot take them while this
        prompt streams in), make the private cache (contiguous: a whole
        row of ``cache_len``; paged: the prompt's allocation) and split
        the prompt into chunks (:meth:`_join_chunks`); in a speculating
        session with a model draft, also the draft's private cache and
        its chunks over the prompt. No device work yet: each
        :meth:`join_step` runs one chunk.

        A prefix-store hit seeds the private cache's first ``common``
        positions from the store's slab and chunks only the tail, at
        absolute offsets; on the paged pool spilled nodes on the path are
        restored (where the free list holds them) and the store's resident
        leading pages are mapped read-only into the row. A speculating
        session's draft prefills over the whole prompt."""
        if not self.can_join(request):
            raise RuntimeError("request cannot join this session")
        r = self._free_slot()
        eng = self.engine
        ids = self.tok.encode(request.prompt)
        hit = self._prefix_hit(ids)
        seed = None
        if hit is not None:
            # the slab first: a path that raced an eviction joins cold
            seed = self.store.seed(self.model, ids, hit["common"])
            if seed is None:
                hit = None
        common = hit["common"] if hit is not None else 0
        chunk = _floor_bucket(int(chunk_tokens or JOIN_PREFILL_CHUNK_TOKENS), PROMPT_BUCKETS)

        def tail_chunks(at: int, width: Optional[int]) -> "List[tuple]":
            return [(at + s0, b) for s0, b in _prompt_chunks(len(ids) - at, width)]

        if common:
            chunks = tail_chunks(common, chunk)
            if not self.paged and chunks[-1][0] + chunks[-1][1] > self.cache_len:
                # the bucket rounding overshot the row cache: the standard
                # chunks, then less of the hit until the tail's end fits
                chunks = tail_chunks(common, None)
                while common > 0 and chunks[-1][0] + chunks[-1][1] > self.cache_len:
                    common -= 1
                    chunks = tail_chunks(common, None)
        if not common:  # no hit, or none left after the overshoot
            hit = None
            chunks = self._join_chunks(ids, chunk_tokens)
        shared = 0
        if self.paged:
            cache_len = chunks[-1][0] + chunks[-1][1]
            need = self._pages_needed(len(ids))
            shared_ids: List[int] = []
            if hit is not None and common // self.page_size:
                # spilled nodes on the path come back into fresh store
                # pages first, where the free list holds them (the pool is
                # written in place: the carry holds the same tensors)
                if hit["restore_nodes"] and (
                    need - hit["full_pages"] + hit["restore_pages"] <= self.pool.free_pages
                ):
                    self.store.restore(self.model, ids, common)
                shared_ids = self.store.page_plan(self.model, ids, common)["hbm_lead"]
            shared = len(shared_ids)
            pages = self.pool.alloc(need - shared, shard=self._row_shard(r))
            if shared:
                # read-only mappings: one reference each, recycled when
                # the last reader (row or store node) lets go
                self.pool.share(shared_ids)
                pages = list(shared_ids) + pages
        else:
            cache_len, pages = self.cache_len, []
        k_cache, v_cache = eng._models[self.model].init_cache(1, cache_len, dtype=eng.dtype)
        if hit is not None:
            # the store's exact pre-quantization K/V: the tail prefill
            # attends to the prefix at the solo path's precision
            k_seed, v_seed = seed
            k_cache[:, 0, :, :common].copy_(k_seed[:, :, :common])
            v_cache[:, 0, :, :common].copy_(v_seed[:, :, :common])
            self.store.record_hit(self.model, ids)
            # positions past the last shared page boundary are copied into
            # the joiner's own page at commit (paged), or live only in its
            # private cache (contiguous)
            observe_hit(common, shared, cow=self.paged and common > shared * self.page_size)
        presence = None
        if request.repeat_penalty != 1.0:
            presence = torch.zeros((1, self.cfg.vocab_size), dtype=torch.bool, device=eng.device)
            presence[0, torch.tensor(ids, device=eng.device)] = True
        pending = _PendingJoin(request, r, ids, chunks, k_cache, v_cache, presence, pages)
        pending.hit_tokens = common
        pending.shared_pages = shared
        if self.spec is not None and self.spec["draft"] is not None:
            # a hit seeds the target only: the draft prefills the prompt
            self._begin_draft_prefill(pending, ids, chunk_tokens)
        self._pending[r] = pending
        return pending

    def join_step(self, pending: _PendingJoin) -> bool:
        """Run one prefill chunk of a pending join into its private cache
        (a chunk at offset > 0 attends to the chunks before it, as the
        solo path's chunked prefill does): the target's chunks, then a
        speculating session's draft chunks (those bill wall time only:
        this session's model would misprice the draft). Fenced, so the
        caller's clock around it is the stall of the rows in flight. True
        once everything is in (commit next); a session that fell back to
        plain decode no longer needs the draft chunks."""
        if pending.next_chunk >= len(pending.chunks) and self._draft_pending(pending):
            t0 = time.monotonic()
            self._prefill_chunk(self.spec["draft"], pending, draft=True)
            pending.draft_next += 1
            dt = time.monotonic() - t0
            pending.prefill_s += dt
            if _obs_enabled():
                self._attr_totals["wall"] += dt
                pending.attr_wall += dt
        elif pending.next_chunk < len(pending.chunks):
            t0 = time.monotonic()
            start, real = self._prefill_chunk(self.model, pending, draft=False)
            pending.next_chunk += 1
            dt = time.monotonic() - t0
            pending.prefill_s += dt
            if _obs_enabled():
                try:
                    self._attr_chunk(pending, start, real, dt)
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
        return pending.next_chunk >= len(pending.chunks) and not self._draft_pending(pending)

    def _draft_pending(self, pending: _PendingJoin) -> bool:
        return self.spec is not None and pending.draft_next < len(pending.draft_chunks)

    def _prefill_chunk(self, model: str, pending: _PendingJoin, draft: bool) -> "tuple[int, int]":
        """The pending row's next chunk through ``model`` into its private
        cache (the draft's, with ``draft``), fenced; the target's keeps
        the chunk's last logits for the first token. Returns (start, real
        tokens)."""
        eng = self.engine
        tf = eng._models[model]
        if draft:
            start, bucket = pending.draft_chunks[pending.draft_next]
            ids = pending.draft_ids[start : start + bucket]
            k_cache, v_cache = pending.draft_k, pending.draft_v
        else:
            start, bucket = pending.chunks[pending.next_chunk]
            ids = pending.ids[start : start + bucket]
            k_cache, v_cache = pending.k_cache, pending.v_cache
        real = len(ids)
        tokens = torch.tensor(
            [ids + [self.tok.pad_id] * (bucket - real)], dtype=torch.long, device=eng.device
        )
        hidden, _, _ = forward(
            tf.params, tf.cfg, tokens, start, k_cache, v_cache,
            None, cuda_prefill_attention, layers=tf.layers,
        )
        if not draft:
            pending.logits = logits_for(tf.params, tf.cfg, hidden[:, real - 1])
        eng._sync()
        return start, real

    def join_commit(self, pending: _PendingJoin) -> int:
        """Finish a fully prefilled join: sample the first token exactly
        as the solo path does (a generator seeded with the request's
        seed, the same sampler call), install the private cache (the
        contiguous row, or the reserved pages with the slot's side-cache
        columns cleared of the previous occupant's K/V) and seat the row;
        it decodes from the next slice. A resume (``pending.resume``)
        commits through :meth:`_commit_resume` once its chunks are in.
        Returns the slot."""
        if pending.next_chunk < len(pending.chunks) or self._draft_pending(pending):
            raise RuntimeError(
                f"join not fully prefilled: chunk {pending.next_chunk} of {len(pending.chunks)} "
                f"(+ draft {pending.draft_next} of {len(pending.draft_chunks)})"
            )
        if pending.resume is not None:
            return self._commit_resume(pending)
        eng = self.engine
        request = pending.request
        use_rp = request.repeat_penalty != 1.0
        t0 = time.monotonic()
        gen = torch.Generator(device=eng.device).manual_seed(request.seed)
        first = sample_token(
            pending.logits, gen, request.temperature, request.top_k,
            request.top_p if request.top_p < 1.0 else None,
            pending.presence, request.repeat_penalty if use_rp else None,
        )
        first_id = int(first[0])
        if use_rp:
            pending.presence[0, first_id] = True
        r = pending.slot
        del self._pending[r]
        k_private, v_private = pending.k_cache, pending.v_cache
        if self.paged:
            self._scatter_private_cache(r, pending)
        else:
            self._install_contiguous_row(r, pending)
        if self.store is not None:
            # publish at commit: the next sharer seeds from this prompt's
            # slab (the seeded region is in the private cache too) and
            # maps this joiner's own full tail pages
            self._publish_prefix(pending.ids, k_private, v_private, pending.pages)
        del k_private, v_private
        if self.spec is not None:
            # the joiner inherits the session's draft config: its draft
            # row (at offset len(prompt)) or its n-gram history (prompt +
            # first token), counters from 0
            if self.spec["draft"] is None:
                self._set_ngram_row(r, pending.ids + [first_id])
            else:
                self._install_draft_row(r, pending.draft_k, pending.draft_v, len(pending.ids))
            self._reset_spec_row(r)
        eng._sync()
        dt = time.monotonic() - t0
        pending.prefill_s += dt
        if _obs_enabled():
            self._attr_totals["wall"] += dt
            pending.attr_wall += dt
            _PREFILL_H.observe(pending.prefill_s)
        self._seat_row(
            request, r, first_token=first_id, gen=gen,
            presence_row=None if pending.presence is None else pending.presence[0],
            offsets=len(pending.ids), prompt_len=len(pending.ids),
            remaining=request.max_new_tokens - 1, pages=pending.pages,
            t0=pending.t0, t1=pending.t0 + pending.prefill_s,
        )
        self.rows[r].take_account(pending)
        return r

    def join_abort(self, pending: _PendingJoin) -> None:
        """Drop a pending join (a failed chunk, a cancelled ticket,
        shutdown): the slot (and its pages) are free again."""
        self._pending.pop(pending.slot, None)
        self._attr_drop(pending)
        if pending.pages:
            self.pool.free(pending.pages)
            pending.pages = []

    def _set_table_row(self, r: int, pages: "List[int]") -> None:
        row = [self._parking_for(r)] * self.jmax
        row[: len(pages)] = pages
        self.carry["table"][r] = torch.tensor(row, dtype=torch.int32, device=self.engine.device)

    def _install_draft_row(self, r: int, k_row, v_row, offset: int) -> None:
        """A draft-cache row [L, 1, Hkv, T, D] (any device) into slot ``r``
        of the session's draft cache, with its offset."""
        _set_row(self.carry["draft_k"], r, k_row)
        _set_row(self.carry["draft_v"], r, v_row)
        self.carry["draft_offsets"][r] = offset

    def _install_contiguous_row(self, r: int, pending: _PendingJoin) -> None:
        """The private cache, every one of its ``cache_len`` positions,
        into row ``r`` of the batch cache (quantized on the way for an
        int8-KV engine, per position and head, as the opening rows were):
        a joiner's prompt, or a recompute resume's prompt and generated
        tokens."""
        k_row, v_row = pending.k_cache, pending.v_cache
        pending.k_cache = pending.v_cache = None
        if self.engine.kv_quantize:
            k_row, v_row = quantize_kv_cache(k_row, v_row)
        _set_row(self.carry["k_cache"], r, k_row)
        _set_row(self.carry["v_cache"], r, v_row)

    def _scatter_private_cache(self, r: int, pending: _PendingJoin) -> None:
        """The joiner's prompt K/V from its private cache into its own
        pages (quantized on the way into an int8 pool, as the opening
        rows'), its table row, and its side-cache columns zeroed: the slot
        may hold a retired row's generated K/V. The first
        ``pending.shared_pages`` pages are the store's, read-only: the
        scatter starts past them, so the seeded positions of a partial
        boundary page land in the joiner's own page (copy on write)."""
        s_real = len(pending.ids)
        base = min(pending.shared_pages, -(-s_real // self.page_size))
        start = base * self.page_size
        if start < s_real:
            ck = _paginate(pending.k_cache[:, 0, :, start:], s_real - start, self.page_size)
            cv = _paginate(pending.v_cache[:, 0, :, start:], s_real - start, self.page_size)
            if self.pool.quantized:
                ck, cv = quantize_chunks(ck, cv)
            scatter_pages(self.pool.k, self.pool.v, pending.pages[base:], ck, cv)
        pending.k_cache = pending.v_cache = None
        self._set_table_row(r, pending.pages)
        for key in ("side_k", "side_v"):
            _leaf_map(lambda t: t[:, r].zero_(), self.carry[key])

    def _seat_row(
        self, request: GenerationRequest, r: int, *, first_token: int, gen, presence_row,
        offsets: int, prompt_len: int, remaining: int, pages: "List[int]", t0: float,
        t1: float, generated: "Optional[List[int]]" = None, streamed: int = 0,
    ) -> None:
        """Set slot ``r``'s control state and host record: the shared tail
        of seating a joiner (``offsets == prompt_len``, the full budget)
        and re-seating a preempted row. A row with no steps left enters
        done."""
        c = self.carry
        dev = self.engine.device
        c["tokens"][r] = first_token
        c["gens"][r] = gen
        c["knobs"]["temperature"][r] = request.temperature
        c["knobs"]["top_p"][r] = request.top_p
        c["knobs"]["repeat_penalty"][r] = request.repeat_penalty
        if request.repeat_penalty != 1.0:
            if c["presence"] is None:
                c["presence"] = torch.zeros(
                    (len(self.rows), self.cfg.vocab_size), dtype=torch.bool, device=dev
                )
            c["presence"][r] = presence_row.to(dev)
        c["offsets"][r] = offsets
        c["prompt_lens"][r] = prompt_len
        c["remaining"][r] = remaining
        c["done"][r] = remaining <= 0
        self.use_top_p = self.use_top_p or request.top_p < 1.0
        if self._spec_host:
            # a reused slot never reports its previous occupant's counters
            # (after a fallback the host mirrors outlive the carry's)
            for key in self._spec_host:
                self._spec_host[key][r] = 0
        row = _Row(request, prompt_len, first_token, request.max_new_tokens - 1, t0, t1,
                   time.monotonic(), pages)
        if generated is not None:
            row.generated = list(generated)
        row.streamed = streamed
        self.rows[r] = row

    # -- teardown ----------------------------------------------------------------
    def close(self) -> None:
        """Release the session: live rows are abandoned (their partial
        streams are not returned), pending joins aborted, every page
        freed, and the swap ledger of parked victims settled."""
        if self.closed:
            return
        self.closed = True
        if self.spec is not None:
            # it speculated to its close: the source's fallbacks are forgiven
            self.engine._spec_source_clear(self.spec["source"], self.spec["draft"])
        for row in self.rows:
            if row is not None:
                self._attr_drop(row)
                if row.pages:
                    self.pool.free(row.pages)
                    row.pages = []
        for pending in self._pending.values():
            self._attr_drop(pending)
            if pending.pages:
                self.pool.free(pending.pages)
                pending.pages = []
        if self.store is not None:
            # last, with every row's reference freed: the store is now its
            # pages' sole holder, so its resident nodes spill to host
            # memory (the pool's free count is restored) and outlive the
            # session
            self.store.detach_pool(self.model, self.pool if self.paged else None)
        self._pending.clear()
        self._stream_tail.clear()
        self.rows = [None] * len(self.rows)
        if self._swap_bytes or self._swap_rows:
            swap_host_adjust(-self._swap_bytes, rows=-self._swap_rows)
            self._swap_bytes = 0
            self._swap_rows = 0
        # last: the LRU guard may now evict this session's models
        for name in self._session_pins:
            self.engine._session_closed(name)
        self._session_pins = []
