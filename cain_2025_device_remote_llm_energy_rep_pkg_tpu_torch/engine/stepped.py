"""Iteration-level decode sessions over the paged pool.

Counterpart of the part of the JAX package's ``engine/stepped.py`` that
speculative decoding runs on. :meth:`SteppedDecodeSession.open` prefills
the rows as ``generate_batch`` does (grouped prefill, the prompts' K/V
scattered into a page pool) and assembles a resumable decode state at a
fixed row bucket; :meth:`SteppedDecodeSession.step` runs one bounded
slice and retires the rows whose done-mask is set, handing their pages
back to the pool. The state is one dict, ``self.carry``, that every slice
continues.

With a speculative config for the model (the engine's ``speculative=``,
or ``spec_override``) and every opening row eligible, a slice runs
draft-verify ROUNDS (``engine/speculative.py::build_spec_step_fn``)
instead of single-token steps: each row advances by its accepted prefix,
and ``extras["spec"]`` of a retired row reports its rounds, accepted and
drafted tokens. Otherwise a slice runs the batch path's decode steps
(``TorchEngine._paged_decode_steps``). Either way the layout is the
stacked-hybrid one: a read-only pool of prompt pages and side caches for
the generated tokens, with a k-column overshoot in spec mode (a verify
writes up to ``write_pos + k``). The pool keeps the model's native head
dim.

Not ported yet: the contiguous session (``paged_kv=False`` raises),
joins and chunked joins, cancel, preempt/resume, ``stream_deltas``, the
prefix store, dp shards, the adaptive draft length and fallback, the
cross-model draft-waste billing, and slice energy attribution.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from .backend import GenerationRequest, GenerationResult
from .paged_kv import PagePool
from .speculative import DraftSpec
from .torch_engine import (
    BATCH_BUCKETS,
    DECODE_SLICE_STEPS,
    GEN_BUCKETS,
    _apply_stop,
    _bucket,
    _pow2_at_least,
    _prompt_alloc,
    _spec_margin,
)

_SPEC_COUNTERS = ("rounds", "accepted", "drafted", "rejected")


class _Row:
    """Host-side record of one live session row."""

    __slots__ = ("request", "s_real", "generated", "budget", "t0", "t1", "t_decode0", "pages")

    def __init__(self, request, s_real, first, budget, t0, t1, t_decode0, pages):
        self.request = request
        self.s_real = s_real
        self.generated: List[int] = [first]
        self.budget = budget  # decode-loop steps (max_new_tokens - 1)
        self.t0 = t0
        self.t1 = t1
        self.t_decode0 = t_decode0
        self.pages: List[int] = pages


class SteppedDecodeSession:
    """One resumable batched decode over the paged pool (see the module
    docstring). ``rows[r] is None`` marks a free slot; free slots ride
    along done, reading one parking page, as the batch path's pad rows do."""

    def __init__(self, engine, model: str, top_k: int) -> None:
        self.engine = engine
        self.model = model
        self.top_k = top_k
        self.closed = False
        self.carry: Dict[str, Any] = {}
        self.rows: List[Optional[_Row]] = []
        # the active speculative config ({source, draft, k, dcfg, floor})
        # or None; spec_info is what retiring rows report
        self.spec: Optional[Dict[str, Any]] = None
        self.spec_info: Optional[Dict[str, Any]] = None
        self.spec_draft_len = 0
        # host mirrors of the carry's cumulative per-row spec counters
        self._spec_host: Dict[str, List[int]] = {}
        self.use_top_p = False

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
        if not engine.paged_kv:
            raise NotImplementedError(
                "TorchEngine: a stepped session over a contiguous cache "
                "(paged_kv=False) is not ported yet"
            )
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
        self._open_paged(requests, all_ids)
        if self.spec is not None:
            if self.spec["draft"] is not None:
                self._open_draft(all_ids)
            else:
                self._open_ngram(all_ids)
        return self

    def _init_spec(self, requests, all_ids, spec_accept_floor, spec_override) -> None:
        """Decide whether this session runs draft-verify: a DraftSpec
        applies (``spec_override``, else the engine's config), every
        opening row is eligible and, for a model draft, the draft shares
        the target's vocabulary and its contiguous cache fits its
        ``max_seq_len``. Any miss serves the session plain: configuring
        a draft never fails a request that plain decode would serve."""
        eng = self.engine
        spec = spec_override if spec_override is not None else eng._resolve_spec(self.model)
        if spec is None or not all(eng._spec_eligible(r) for r in requests):
            return
        floor = eng.spec_accept_floor if spec_accept_floor is None else float(spec_accept_floor)
        if floor > 0.0:
            raise NotImplementedError(
                "TorchEngine: spec_accept_floor (the adaptive fallback) is not ported yet"
            )
        draft_len = (
            max(_prompt_alloc(max(len(i), 1)) for i in all_ids) + self.g_bucket + _spec_margin(spec.k)
        )
        dcfg = None
        if spec.draft is not None:
            eng.load_model(spec.draft)
            dcfg = eng._models[spec.draft].cfg
            if dcfg.vocab_size != self.cfg.vocab_size:
                warnings.warn(
                    f"speculative session: draft {spec.draft} vocab {dcfg.vocab_size} != "
                    f"target vocab {self.cfg.vocab_size}; serving plain"
                )
                return
            if draft_len > dcfg.max_seq_len:
                return
        self.spec = {
            "source": spec.source, "draft": spec.draft, "k": spec.k, "dcfg": dcfg,
            "floor": floor,
        }
        self.spec_info = {"draft_model": spec.draft, "k": spec.k, "source": spec.source}
        self.spec_draft_len = draft_len

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
        self.pool = PagePool.create(
            n_layers=cfg.n_layers, n_pages=_pow2_at_least(2 * (sum(rows_pages) + 1), 4),
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, page_size=self.page_size,
            dtype=eng.dtype, quantized=bool(eng.kv_quantize), device=eng.device,
        )
        self.parking = self.pool.alloc(1)[0]
        table = [[self.parking] * self.jmax for _ in range(self.b_bucket)]
        row_pages = []
        for r, need in enumerate(rows_pages):
            pages = self.pool.alloc(need)
            row_pages.append(pages)
            table[r][:need] = pages
        asm = eng._assemble_rows(states, self.b_bucket, eng._row_field_specs(states))
        eng._scatter_prompts(self.pool, states, asm.pop("_groups"), row_pages, self.parking)
        carry = eng._paged_state(requests, all_ids, states, asm, self.b_bucket)
        carry["pool"] = self.pool
        carry["table"] = torch.tensor(table, dtype=torch.int32, device=eng.device)
        side_cols = self.g_bucket + (self.spec["k"] if self.spec is not None else 0)
        carry["side_k"], carry["side_v"] = eng._side_caches(cfg, self.b_bucket, side_cols)
        self.carry.update(carry)
        self.use_top_p = any(r.top_p < 1.0 for r in requests)
        first = carry["tokens"].tolist()
        t_open = time.monotonic()
        self.rows = [
            _Row(r, st["s_real"], first[i], r.max_new_tokens - 1, st["t0"], st["t1"], t_open, pages)
            for i, (r, st, pages) in enumerate(zip(requests, states, row_pages))
        ] + [None] * (self.b_bucket - len(requests))

    def _pages_needed(self, s_real: int) -> int:
        """Pages one row pins: its prompt's only (generated tokens, and a
        spec row's verify candidates, live in the side caches)."""
        return -(-max(s_real, 1) // self.page_size)

    # -- state ----------------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for r in self.rows if r is not None)

    @property
    def free_slots(self) -> int:
        return sum(1 for r in self.rows if r is None)

    def debug_state(self) -> Dict[str, Any]:
        """A JSON-able snapshot: per-slot row state (age, tokens, budget,
        pages, spec counters), the spec config and totals, and the pool."""
        now = time.monotonic()
        spec_rows = self.spec_info is not None and bool(self._spec_host)
        state: Dict[str, Any] = {
            "model": self.model,
            "closed": self.closed,
            "paged": True,
            "b_bucket": len(self.rows),
            "slice_steps": self.slice_bucket,
            "active": self.active,
            "free_slots": self.free_slots,
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
                            "verify_mode": "native",
                        }
                        if spec_rows else {}
                    ),
                }
                for r, row in enumerate(self.rows)
                if row is not None
            ],
            "pool": self.pool.debug_state(),
        }
        if self.spec_info is not None:
            state["spec"] = {
                "active": self.spec is not None,
                "draft_model": self.spec_info["draft_model"],
                "source": self.spec_info["source"],
                "k": self.spec_info["k"],
                "fallback": False,
                "verify_mode": "native",
                "accept_floor": self.spec["floor"] if self.spec is not None else None,
                **{f"{key}_total": sum(self._spec_host.get(key, [])) for key in _SPEC_COUNTERS},
            }
        return state

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
                self.spec["source"], self.top_k, self.use_top_p,
            )
            draft = eng._models[self.spec["draft"]] if self.spec["draft"] is not None else None
            out, n_row = decode((tf, draft), self.carry, n_real)
        else:
            out, n_row = eng._paged_decode_steps(
                tf, self.carry, n_real, self.top_k, self.tok.eos_id
            )
        out_host = out.tolist()
        n_row_host = n_row.tolist()
        done_host = self.carry["done"].tolist()
        slice_steps = self._spec_after_slice(live) if self.spec is not None else max(
            n_row_host[r] for r in live
        )
        t2 = time.monotonic()
        retired: List[GenerationResult] = []
        for r in live:
            self.rows[r].generated.extend(out_host[r][: n_row_host[r]])
            if done_host[r]:
                retired.append(self._retire(r, t2))
        slice_tokens = sum(n_row_host[r] for r in live)
        if slice_tokens:
            # a spec slice's steps are its rounds: one target forward each
            eng._observe_decode_window(
                t1, t2, slice_tokens, slice_steps, rows=len(live), path="paged"
            )
        return retired

    def _spec_after_slice(self, live: "List[int]") -> int:
        """Refresh the host mirrors of the cumulative spec counters;
        returns the rounds this slice ran (the largest per-row delta:
        every live row rides every round)."""
        new = {key: self.carry["spec_" + key].tolist() for key in _SPEC_COUNTERS}
        rounds = max(new["rounds"][r] - self._spec_host["rounds"][r] for r in live)
        self._spec_host = new
        return rounds

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
            extras["spec"] = {
                **{key: self._spec_host[key][r] for key in _SPEC_COUNTERS},
                "k": self.spec_info["k"],
                "draft_model": self.spec_info["draft_model"],
                "source": self.spec_info["source"],
                "fallback": False,
            }
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
        # park the slot's table row before its pages return to the pool
        self.carry["table"][r] = self.parking
        self.pool.free(row.pages)
        row.pages = []
        self.rows[r] = None
        return result

    def close(self) -> None:
        """Release the session: live rows are abandoned (their partial
        streams are not returned) and their pages freed."""
        if self.closed:
            return
        self.closed = True
        for row in self.rows:
            if row is not None and row.pages:
                self.pool.free(row.pages)
                row.pages = []
        self.rows = [None] * len(self.rows)
