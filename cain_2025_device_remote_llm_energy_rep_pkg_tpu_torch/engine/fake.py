"""Deterministic fake backend for hermetic lifecycle tests.

SURVEY.md §4: the reference has no fakes at all (its "remote" treatment needs
a real second machine); this backend makes the full experiment — run table,
hooks, profilers, persistence, analysis — testable with no accelerator and no
network. Token ids and timings are pure functions of the request.

It also speaks the STEPPED-DECODE protocol (``decode_open`` → session
``step``/``can_join``/``join``/``close``, plus the resumable chunked
join ``join_begin``/``join_step``/``join_commit``/``join_abort``) the
continuous scheduler drives, so iteration-level admission/retirement —
including chunked join-prefill interleaving — is testable hermetically:
a session precomputes each row's deterministic token stream and a
``step(k)`` slice advances every live row's cursor by ``k`` (sleeping
one shared window of ``k / tokens_per_s`` when ``simulate_delay`` — rows
decode together, like the real engine's shared batch window), retiring
rows whose stream is exhausted.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

from ..obs.detect import observe_retired_tokens, observe_slice_tokens
from ..obs.metrics import enabled as _obs_enabled
from .backend import GenerationBackend, GenerationRequest, GenerationResult

class _FakeStepSession:
    """Stepped-decode session over precomputed deterministic streams."""

    # bytes one simulated swapped token costs — keeps the fake's swap
    # counters proportional to real KV so dashboards read sanely
    SWAP_BYTES_PER_TOKEN = 1024

    def __init__(
        self,
        backend: "FakeBackend",
        requests: List[GenerationRequest],
        max_rows: int = 64,
        spec_accept_floor: "Optional[float]" = None,
    ) -> None:
        self.backend = backend
        self.max_rows = max_rows
        self.closed = False
        self.model = requests[0].model if requests else ""
        self.top_k = requests[0].top_k if requests else 0
        self._rows: List[dict] = []
        self._pending: List[dict] = []  # chunked joiners mid-prefill
        # Speculative simulation (the hermetic twin of the stepped
        # sessions' draft-verify mode): with
        # backend.spec_k > 0 each step() slice runs ROUNDS, every live
        # row advancing by 1 + round(acceptance · k) tokens per round
        # (SAMPLED rows — temperature > 0 — use the separate synthetic
        # spec_sampled_acceptance), the llm_spec_* families move with
        # the configured draft-source label, a cross-source session
        # bills fully-rejected rounds' draft tokens into the
        # wasted-energy ledger, and a measured acceptance below the
        # floor flips the session to plain advancement
        # (llm_spec_fallback_total{source}).
        self.spec_k = int(backend.spec_k)
        self.spec_source = str(getattr(backend, "spec_source", "model"))
        self.spec_draft = (
            None
            if self.spec_source == "ngram"
            else str(getattr(backend, "spec_draft", "fake-draft"))
        )
        self.spec_acceptance = float(backend.spec_acceptance)
        sampled_acc = getattr(backend, "spec_sampled_acceptance", None)
        self.spec_sampled_acceptance = (
            self.spec_acceptance if sampled_acc is None else float(sampled_acc)
        )
        self.spec_accept_floor = (
            backend.spec_accept_floor
            if spec_accept_floor is None
            else spec_accept_floor
        )
        self.spec_active = self.spec_k > 0
        self.spec_fallback = False
        # adaptive draft-k twin: the configured length —
        # step() shrinks spec_k toward 1 below the floor instead of
        # falling back, and restores toward spec_k0 on recovery
        # (re-read acceptance each slice so tests can move it live)
        self.spec_k0 = self.spec_k
        # streaming egress twins of SteppedDecodeSession's: the scheduler
        # flips stream_tokens on while any live ticket streams, and
        # retired rows buffer their unstreamed tails for the next
        # stream_deltas() drain
        self.stream_tokens = False
        self._stream_tail: List[tuple] = []
        # preemption swap ledger — the fake twin of the stepped
        # session's, so smoke/CI can assert the swap gauges
        # rise and return exactly to zero with no accelerator
        self._swap_bytes = 0
        self._swap_rows = 0
        self._slices_run = 0  # mid-stream death injection clock
        # per-row slice attribution — the hermetic twin of
        # SteppedDecodeSession's: _attr_totals accumulates every wall
        # second and synthetic Joule the session bills anywhere (slices
        # + join chunks), _attr_dropped the accounts of rows that left
        # without retiring (cancel / abort / close), so conservation —
        # live + retired + dropped == totals — is testable exactly
        self._attr_totals = {"wall": 0.0, "J": 0.0, "J_low": 0.0, "J_high": 0.0}
        self._attr_dropped = {"wall": 0.0, "J": 0.0, "J_low": 0.0, "J_high": 0.0}
        for r in requests:
            self._admit(r)

    def _admit(self, request: GenerationRequest) -> None:
        self._rows.append(
            {
                "request": request,
                "result": self.backend._result(request),
                "cursor": 0,
                "streamed": 0,
                "spec_rounds": 0,
                "spec_accepted": 0,
                "spec_drafted": 0,
                "spec_rejected": 0,
                "draft_wasted_J": 0.0,
                # slice-attribution account: lives on the row
                # dict so it survives preempt/resume for free (the pr
                # parks this same dict). attr_wasted_J is informational
                # (swap mirrors), never folded into attr_J.
                "attr_wall": 0.0,
                "attr_J": 0.0,
                "attr_slices": 0,
                "attr_wasted_J": 0.0,
            }
        )

    @property
    def active(self) -> int:
        return len(self._rows)

    def can_join(self, request: GenerationRequest) -> bool:
        # a killed backend (fail_decode_open) admits no NEW rows while
        # its live rows run to completion — the soft-death shape the
        # router's zero-lost-tickets guarantee is tested against
        return (
            not self.closed
            and not self.backend.fail_decode_open
            and len(self._rows) + len(self._pending) < self.max_rows
        )

    def join(self, request: GenerationRequest) -> int:
        if not self.can_join(request):
            raise RuntimeError("request cannot join this session")
        self._admit(request)
        return len(self._rows) - 1

    # -- resumable (chunked) join, the real engine's protocol ------------------
    def join_begin(
        self, request: GenerationRequest, chunk_tokens: "Optional[int]" = None
    ) -> dict:
        """Reserve a slot and split the prompt into token-budgeted
        prefill chunks (1 byte ≈ 1 prompt token, like the byte
        tokenizer), mirroring ``SteppedDecodeSession.join_begin`` so the
        continuous scheduler's interleave policy is testable
        hermetically."""
        if not self.can_join(request):
            raise RuntimeError("request cannot join this session")
        chunk = max(1, int(chunk_tokens or 256))
        n_prompt = len(request.prompt.encode("utf-8")) + 1
        pending = {
            "request": request,
            "chunk_tokens": chunk,
            "tokens_left": max(1, n_prompt),
            "attr_wall": 0.0,
        }
        self._pending.append(pending)
        return pending

    def join_step(self, pending: dict) -> bool:
        """One prefill chunk; prefill streams ~8 tokens per decode-token
        wall (it is parallel over positions) when simulating delay. The
        chunk's wall bills to the joiner's attribution account; the fake's synthetic energy model prices decode tokens
        only, so chunks carry no Joules here (the real twin estimates
        them from the prefill window)."""
        tokens = min(pending["chunk_tokens"], pending["tokens_left"])
        t0 = time.monotonic()
        if self.backend.simulate_delay:
            time.sleep(max(1, tokens) / (self.backend.tokens_per_s * 8.0))
        pending["tokens_left"] -= tokens
        if _obs_enabled():
            dt = time.monotonic() - t0
            self._attr_totals["wall"] += dt
            pending["attr_wall"] = pending.get("attr_wall", 0.0) + dt
        return pending["tokens_left"] <= 0

    def join_commit(self, pending: dict) -> int:
        if pending["tokens_left"] > 0:
            raise RuntimeError("join not fully prefilled")
        self._pending.remove(pending)
        pr = pending.get("resume")
        if pr is not None:
            # re-seat the preempted row exactly where it stopped: the
            # cursor (and streamed watermark) carry over, so the final
            # stream is identical to an uninterrupted run (the row dict
            # carries its attribution account through the park; the
            # re-prefill chunks' wall joins it here)
            row = pr["row"]
            row["attr_wall"] += pending.get("attr_wall", 0.0)
            self._rows.append(row)
            self._swap_settle(pr, transfer=True)
            return len(self._rows) - 1
        self._admit(pending["request"])
        self._rows[-1]["attr_wall"] += pending.get("attr_wall", 0.0)
        return len(self._rows) - 1

    # -- mid-flight preemption (the stepped session's twin) -----------
    def _swap_settle(self, pr: dict, transfer: bool) -> None:
        """Settle one parked victim's swap ledger (idempotent): count
        the host→device transfer when it actually resumed."""
        if pr.get("discharged"):
            return
        pr["discharged"] = True
        nbytes = pr.get("host_bytes", 0)
        if not nbytes or self.closed:  # close() settled the ledger
            return
        from ..obs.metrics import observe_swap, swap_host_adjust

        if transfer:
            observe_swap("in", nbytes)
        self._swap_bytes = max(0, self._swap_bytes - nbytes)
        self._swap_rows = max(0, self._swap_rows - 1)
        swap_host_adjust(-nbytes, rows=-1)
        pr["host_bytes"] = 0

    def preempt(self, request: GenerationRequest, policy: str = "swap"):
        """Retire a live row NOW and capture what resume needs — the
        fake twin of ``SteppedDecodeSession.preempt``. ``swap`` counts
        simulated KV bytes out (restored at resume); ``recompute``
        parks the row with its re-prefill cost charged at resume."""
        for row in self._rows:
            if row["request"] is request:
                self._rows.remove(row)
                tokens_resident = row["result"].prompt_tokens + min(
                    row["cursor"], row["result"].generated_tokens
                )
                host_bytes = (
                    tokens_resident * self.SWAP_BYTES_PER_TOKEN
                    if policy == "swap"
                    else 0
                )
                pr = {
                    "request": request,
                    "row": row,
                    "policy": policy,
                    "generated": row["result"].tokens[
                        : min(row["cursor"], row["result"].generated_tokens)
                    ],
                    "prompt_len": row["result"].prompt_tokens,
                    "host_bytes": host_bytes,
                    "discharged": False,
                }
                if host_bytes:
                    from ..obs.metrics import (
                        observe_swap,
                        swap_host_adjust,
                    )

                    observe_swap("out", host_bytes)
                    self._swap_bytes += host_bytes
                    self._swap_rows += 1
                    swap_host_adjust(host_bytes, rows=1)
                return pr
        return None

    def can_resume(self, pr: dict) -> bool:
        return (
            not self.closed
            and len(self._rows) + len(self._pending) < self.max_rows
        )

    def resume_begin(
        self, pr: dict, chunk_tokens: "Optional[int]" = None
    ) -> dict:
        """Re-admit a preempted row through the chunked-join machinery:
        a swap resume has no prefill to redo (zero-token pending); a
        recompute resume re-prefills prompt + generated-so-far in
        chunks that interleave like any joiner's."""
        if not self.can_resume(pr):
            raise RuntimeError("preempted row cannot resume")
        row = pr["row"]
        if pr["policy"] == "swap":
            tokens_left = 0
        else:
            tokens_left = row["result"].prompt_tokens + min(
                row["cursor"], row["result"].generated_tokens
            )
        pending = {
            "request": pr["request"],
            "chunk_tokens": max(1, int(chunk_tokens or 256)),
            "tokens_left": tokens_left,
            "resume": pr,
            "attr_wall": 0.0,
        }
        self._pending.append(pending)
        return pending

    def resume_discard(self, pr: dict) -> None:
        self._swap_settle(pr, transfer=False)

    def join_abort(self, pending: dict) -> None:
        if pending in self._pending:
            self._pending.remove(pending)
            self._attr_dropped["wall"] += pending.get("attr_wall", 0.0)
            pending["attr_wall"] = 0.0

    @property
    def pending_joins(self) -> int:
        return len(self._pending)

    @property
    def free_slots(self) -> int:
        """Open row slots (mirrors the real session's property — the
        continuous scheduler's admission-headroom signal reads it)."""
        return self.max_rows - len(self._rows) - len(self._pending)

    def debug_state(self) -> dict:
        """JSON-able session snapshot — the fake twin of
        ``SteppedDecodeSession.debug_state`` so ``GET /debug/state`` is
        testable hermetically."""
        state = {
            "model": self.model,
            "closed": self.closed,
            "paged": False,
            "b_bucket": self.max_rows,
            "active": self.active,
            "free_slots": self.max_rows - len(self._rows) - len(self._pending),
            "pending_joins": len(self._pending),
            "rows": [
                {
                    "slot": i,
                    "prompt_tokens": row["result"].prompt_tokens,
                    "generated_tokens": min(
                        row["cursor"], row["result"].generated_tokens
                    ),
                    "budget": row["result"].generated_tokens,
                    **(
                        {
                            "spec_rounds": row["spec_rounds"],
                            "spec_accepted": row["spec_accepted"],
                            "verify_mode": "native",
                        }
                        if self.spec_k > 0
                        else {}
                    ),
                }
                for i, row in enumerate(self._rows)
            ],
            "pending": [
                {"tokens_left": pj["tokens_left"]} for pj in self._pending
            ],
            "swap": {
                "host_rows": self._swap_rows,
                "host_bytes": self._swap_bytes,
            },
        }
        if self.spec_k > 0:
            state["spec"] = {
                "active": self.spec_active,
                "source": self.spec_source,
                "draft_model": self.spec_draft,
                "k": self.spec_k,
                "fallback": self.spec_fallback,
                "accept_floor": self.spec_accept_floor,
                "acceptance_recent": self.spec_acceptance,
                # the fake models the native verify: no slack
                # billing, no scratch bytes to hold
                "verify_mode": "native",
                "scratch_bytes": 0,
            }
        return state

    def _spec_k_event(
        self, k_old: int, k_new: int, measured: float
    ) -> None:
        """Publish one adaptive draft-length move (counter + flight) —
        the fake twin of SteppedDecodeSession._spec_set_k's obs tail."""
        try:
            from ..obs.flight import EV_SPEC_K_ADAPT, FLIGHT
            from ..obs.metrics import SPEC_K_ADAPT_C

            SPEC_K_ADAPT_C.labels(
                source=self.spec_source,
                direction="down" if k_new < k_old else "up",
            ).inc()
            FLIGHT.emit(
                EV_SPEC_K_ADAPT,
                model=self.model,
                source=self.spec_source,
                k_from=k_old,
                k_to=k_new,
                acceptance=round(measured, 4),
                floor=self.spec_accept_floor,
            )
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def _attr_slice(self, counts: Dict[int, int], wall: float) -> None:
        """Split one slice's wall and synthetic Joules across live rows
        by token share (the hermetic twin of
        ``SteppedDecodeSession._attr_slice``): the fake's energy model
        is ``jpt × tokens``, so a row's slice share is exactly
        ``jpt × its clamped new tokens`` and lifetime sums equal the
        whole-request figure ``_observe_energy`` reports."""
        slice_tokens = sum(counts.values())
        if not slice_tokens:
            return
        jpt = self.backend._jpt_for(self.model)
        j_slice = jpt * slice_tokens
        self._attr_totals["wall"] += wall
        self._attr_totals["J"] += j_slice
        self._attr_totals["J_low"] += j_slice
        self._attr_totals["J_high"] += j_slice
        for i, cnt in counts.items():
            if not cnt:
                continue
            row = self._rows[i]
            row["attr_wall"] += wall * (cnt / slice_tokens)
            row["attr_J"] += jpt * cnt
            row["attr_slices"] += 1

    def _attr_drop(self, account: dict) -> None:
        """A row (or joiner) leaves without retiring: its account moves
        to the dropped bucket so conservation still closes."""
        self._attr_dropped["wall"] += account.get("attr_wall", 0.0)
        j = account.get("attr_J", 0.0)
        self._attr_dropped["J"] += j
        self._attr_dropped["J_low"] += j
        self._attr_dropped["J_high"] += j
        account["attr_wall"] = 0.0
        account["attr_J"] = 0.0

    def _close_out_energy(self, row: dict, res: GenerationResult) -> None:
        """Stamp the retiring row's accumulated slice account into
        ``extras["energy_model"]`` (window ``slice``), overriding the
        whole-request figure ``_observe_energy`` wrote — same wire shape
        as the real session's close-out. Rounded at 9dp so the 1e-6
        conservation invariant survives the wire."""
        gen = res.generated_tokens
        j = row["attr_J"]
        em = {
            "J": round(j, 9),
            "J_low": round(j, 9),
            "J_high": round(j, 9),
            "J_per_token": round(j / gen, 9) if gen else 0.0,
            "J_per_token_low": round(j / gen, 9) if gen else 0.0,
            "J_per_token_high": round(j / gen, 9) if gen else 0.0,
            "wall_attr_s": round(row["attr_wall"], 9),
            "slices": row["attr_slices"],
            "window": "slice",
        }
        wasted = row["attr_wasted_J"] + row["draft_wasted_J"]
        if wasted:
            em["wasted_J"] = round(wasted, 9)
        res.extras = {**(res.extras or {}), "energy_model": em}

    def step(self, max_steps: int = 16) -> List[GenerationResult]:
        if self.closed:
            raise RuntimeError("session is closed")
        t_slice = time.monotonic()
        # simulated mid-stream death (router/failure-path tests): the
        # session dies AFTER fail_after_slices slices completed — rows
        # may already have streamed tokens, so a front-door router must
        # NOT retry (the never-after-first-streamed-token rule)
        if self.backend.fail_after_slices is not None:
            self._slices_run += 1
            if self._slices_run > self.backend.fail_after_slices:
                raise RuntimeError("fake backend died mid-stream")
        if self.backend.simulate_delay and self._rows:
            # one SHARED window per slice, not per row — the semantics of
            # a real batched decode slice
            time.sleep(max_steps / self.backend.tokens_per_s)
        # speculative simulation: a slice is ROUNDS — each live row
        # advances by 1 + accepted-per-round tokens per round, mirroring
        # the real session's per-row variable stride. Sampled rows
        # (temperature > 0) advance at the separate synthetic
        # spec_sampled_acceptance — the hermetic stand-in for rejection
        # resampling's acceptance rate.
        if self.spec_active and self._rows:
            # live re-read (adaptive draft-k twin): tests move the
            # backend's synthetic acceptance mid-session to walk the
            # session through shrink → recover → restore
            self.spec_acceptance = float(self.backend.spec_acceptance)
            sampled_acc = getattr(
                self.backend, "spec_sampled_acceptance", None
            )
            self.spec_sampled_acceptance = (
                self.spec_acceptance
                if sampled_acc is None
                else float(sampled_acc)
            )
            tot_accepted = tot_drafted = tot_rejected = 0
            for row in self._rows:
                sampled = row["request"].temperature > 0
                acc = (
                    self.spec_sampled_acceptance
                    if sampled
                    else self.spec_acceptance
                )
                per_round = 1 + max(
                    0, min(self.spec_k, round(acc * self.spec_k))
                )
                accepted = (per_round - 1) * max_steps
                drafted = self.spec_k * max_steps
                row["spec_rounds"] += max_steps
                row["spec_accepted"] += accepted
                row["spec_drafted"] += drafted
                row["advance"] = max_steps * per_round
                tot_accepted += accepted
                tot_drafted += drafted
                if per_round == 1:
                    # every drafted token rejected all slice long: a
                    # cross-model source bills the draft lane's burned
                    # tokens to the wasted-energy ledger, priced at the
                    # draft model's live J/token when the fleet hook
                    # knows it (serve/model_fleet.py)
                    row["spec_rejected"] += max_steps
                    tot_rejected += max_steps * self.spec_k
                    if self.spec_source == "cross":
                        try:
                            from ..obs.energy import charge_wasted

                            hook = getattr(
                                self.backend, "spec_draft_jpt", None
                            )
                            jpt = (
                                hook(self.spec_draft)
                                if hook is not None
                                else None
                            ) or self.backend._jpt_for(
                                self.spec_draft
                            ) or None
                            row["draft_wasted_J"] += charge_wasted(
                                "draft",
                                tokens=float(max_steps * self.spec_k),
                                jpt=jpt,
                            )
                        except Exception:  # noqa: BLE001 — telemetry only
                            pass
            try:
                from ..obs.metrics import SPEC_VERIFY_NATIVE_C, observe_spec

                observe_spec(
                    max_steps,
                    tot_accepted,
                    tot_drafted,
                    source=self.spec_source,
                    rejected=tot_rejected,
                )
                # the fake simulates the native verify (its
                # rows bill no slack anywhere), so the migration
                # counter moves in hermetic CI exactly like a real
                # paged session's
                SPEC_VERIFY_NATIVE_C.inc(max_steps)
            except Exception:  # noqa: BLE001 — telemetry only
                pass
            floor = self.spec_accept_floor
            measured = (
                tot_accepted / tot_drafted if tot_drafted else None
            )
            if floor and measured is not None and measured < floor:
                if self.spec_k > 1:
                    # adaptive draft-k: shrink before
                    # abandoning — the real session's halving policy
                    k_old = self.spec_k
                    self.spec_k = max(1, self.spec_k // 2)
                    self._spec_k_event(k_old, self.spec_k, measured)
                else:
                    self.spec_active = False
                    self.spec_fallback = True
                    try:
                        from ..obs.flight import EV_SPEC_FALLBACK, FLIGHT
                        from ..obs.metrics import SPEC_FALLBACK_C

                        SPEC_FALLBACK_C.labels(
                            source=self.spec_source
                        ).inc()
                        FLIGHT.emit(
                            EV_SPEC_FALLBACK,
                            model=self.model,
                            source=self.spec_source,
                            acceptance=round(measured, 4),
                            floor=floor,
                        )
                    except Exception:  # noqa: BLE001 — telemetry only
                        pass
            elif (
                floor
                and measured is not None
                and self.spec_k < self.spec_k0
                and measured >= min(0.95, floor + 0.15)
            ):
                # recovery: restore toward the configured length (the
                # same hysteresis band the real session applies)
                k_old = self.spec_k
                self.spec_k = min(self.spec_k0, self.spec_k * 2)
                self._spec_k_event(k_old, self.spec_k, measured)
        # slice attribution BEFORE the retire loop, so
        # retiring rows carry the final slice's share: each live row's
        # new tokens this slice, clamped to its remaining budget
        if _obs_enabled() and self._rows:
            try:
                counts = {}
                for i, row in enumerate(self._rows):
                    gen = row["result"].generated_tokens
                    old = min(row["cursor"], gen)
                    adv = row.get("advance", max_steps)
                    counts[i] = min(row["cursor"] + adv, gen) - old
                self._attr_slice(counts, time.monotonic() - t_slice)
            except Exception:  # noqa: BLE001 — telemetry only
                pass
        retired, keep = [], []
        for row in self._rows:
            row["cursor"] += row.pop("advance", max_steps)
            if row["cursor"] >= row["result"].generated_tokens:
                res = row["result"]
                self.backend._observe_energy(res)
                res.extras = {
                    **(res.extras or {}),
                    "retire_reason": "budget",
                    "stepped": True,
                }
                if self.spec_k > 0:
                    res.extras["spec"] = {
                        "rounds": row["spec_rounds"],
                        "accepted": row["spec_accepted"],
                        "drafted": row["spec_drafted"],
                        "rejected": row["spec_rejected"],
                        "k": self.spec_k,
                        "source": self.spec_source,
                        "draft_model": self.spec_draft,
                        "fallback": self.spec_fallback,
                    }
                    if row["draft_wasted_J"]:
                        res.extras["spec"]["draft_wasted_J"] = round(
                            row["draft_wasted_J"], 6
                        )
                if _obs_enabled() and (
                    row["attr_slices"] or row["attr_wall"]
                ):
                    try:
                        self._close_out_energy(row, res)
                    except Exception:  # noqa: BLE001 — telemetry only
                        pass
                if self.stream_tokens and row["streamed"] < len(res.tokens):
                    tail = res.tokens[row["streamed"] :]
                    self._stream_tail.append(
                        (res.request, tail, res.text[row["streamed"] :])
                    )
                retired.append(res)
            else:
                keep.append(row)
        # goodput accounting, same convention as the real stepped path
        # (obs/detect.py): every row steps the whole slice; completed
        # rows credit their generated tokens
        observe_slice_tokens(max_steps, len(self._rows))
        for res in retired:
            observe_retired_tokens(res.generated_tokens)
        self._rows = keep
        return retired

    def stream_deltas(self) -> List[tuple]:
        """``(request, tokens, text)`` per row since the previous call —
        the fake twin of ``SteppedDecodeSession.stream_deltas`` (1 token
        ≙ 1 text char here, so text deltas are exact slices)."""
        out: List[tuple] = list(self._stream_tail)
        self._stream_tail.clear()
        for row in self._rows:
            res = row["result"]
            avail = min(row["cursor"], res.generated_tokens)
            if avail <= row["streamed"]:
                continue
            tokens = res.tokens[row["streamed"] : avail]
            text = res.text[row["streamed"] : avail]
            row["streamed"] = avail
            out.append((res.request, tokens, text))
        return out

    def cancel(self, request: GenerationRequest) -> bool:
        """Retire a live row without completing it (fake twin of
        ``SteppedDecodeSession.cancel``): the slot frees immediately and
        the partial stream is discarded."""
        for row in self._rows:
            if row["request"] is request:
                self._rows.remove(row)
                self._attr_drop(row)
                return True
        return False

    def close(self) -> None:
        self.closed = True
        for row in self._rows:
            self._attr_drop(row)
        for pending in self._pending:
            self._attr_drop(pending)
        self._rows = []
        self._pending = []
        self._stream_tail = []
        if self._swap_bytes or self._swap_rows:
            # parked victims die with the session: settle the ledger so
            # the host-residency gauges return exactly to idle
            from ..obs.metrics import swap_host_adjust

            swap_host_adjust(-self._swap_bytes, rows=-self._swap_rows)
            self._swap_bytes = 0
            self._swap_rows = 0


class FakeBackend(GenerationBackend):
    def __init__(
        self,
        tokens_per_s: float = 1000.0,
        simulate_delay: bool = False,
        prefix_share: bool = False,
        prefix_store_hbm_bytes: "Optional[int]" = None,
        prefix_store_host_bytes: "Optional[int]" = None,
        spec_k: int = 0,
        spec_acceptance: float = 1.0,
        spec_sampled_acceptance: "Optional[float]" = None,
        spec_accept_floor: "Optional[float]" = None,
        spec_source: str = "model",
        spec_draft: str = "fake-draft",
        max_rows: int = 64,
        joules_per_token: float = 0.0,
        model_joules: "Optional[Dict[str, float]]" = None,
        model_bytes: "Optional[Dict[str, int]]" = None,
        clock=None,
    ):
        if prefix_share or prefix_store_hbm_bytes or prefix_store_host_bytes:
            raise NotImplementedError(
                "FakeBackend: the shared-prefix store is not ported yet "
                "(ROADMAP item 12)"
            )
        self.tokens_per_s = tokens_per_s
        self.simulate_delay = simulate_delay
        # Deterministic clock hook: tests hand ONE hand-driven
        # clock to this backend, the time-series ring and the SLO engine
        # so window math over a fake fleet is hermetic — no sleeps, no
        # wall-clock jitter. None = time.monotonic (production).
        self.clock = clock if clock is not None else time.monotonic
        # Synthetic energy attribution: a non-zero value makes
        # this fake report that J/token for every served request — into
        # the shared llm_request_joules_per_token family (so a remote
        # fake replica's /metrics scrape feeds the router's least-joules
        # policy and the fleet J/token rollup) and as the live
        # ``last_joules_per_token`` attribute LocalReplica probes read.
        # Two fakes with different figures make least-joules testable
        # hermetically.
        self.joules_per_token = float(joules_per_token)
        self.last_joules_per_token: "Optional[float]" = (
            self.joules_per_token or None
        )
        # Multi-model twins: per-model synthetic J/token (the
        # fleet's cheapest-joules policy ranks on the live by-model
        # split) and per-model simulated weight bytes (the small-first
        # policy's size ordering and the llm_model_weight_bytes gauge).
        self.model_joules: Dict[str, float] = dict(model_joules or {})
        self.model_bytes: Dict[str, int] = dict(model_bytes or {})
        self.last_joules_per_token_by_model: Dict[str, float] = {}
        # Failure injection for router/failure-path tests —
        # both MUTABLE so a test can kill a live replica mid-trace:
        # fail_decode_open makes every session open raise (a replica
        # dying mid-prefill — retryable at the front door);
        # fail_after_slices kills a live session after that many decode
        # slices (mid-stream death — NOT retryable, rows already
        # streamed).
        self.fail_decode_open = False
        self.fail_after_slices: Optional[int] = None
        # session row capacity: small values simulate a saturated pool
        # so scheduler preemption is testable hermetically
        self.max_rows = int(max_rows)
        # the fake twin of TorchEngine(speculative=..., spec_accept_floor=):
        # spec_k > 0 makes stepped sessions speak the draft-verify
        # protocol with CONFIGURABLE synthetic acceptance — llm_spec_*
        # families, per-row spec debug fields and the auto-fallback are
        # CI-testable with no accelerator (see _FakeStepSession.step).
        # twins: spec_source labels the metric families
        # ("model" | "ngram" | "cross"), spec_sampled_acceptance is the
        # separate synthetic acceptance sampled rows (temperature > 0)
        # advance at (default: same as greedy), and a cross source
        # bills fully-rejected rounds' draft tokens as wasted Joules —
        # priced by the spec_draft_jpt fleet hook when wired, exactly
        # like the real engine.
        self.spec_k = int(spec_k)
        self.spec_source = str(spec_source)
        self.spec_draft = str(spec_draft)
        self.spec_acceptance = float(spec_acceptance)
        self.spec_sampled_acceptance = (
            float(spec_sampled_acceptance)
            if spec_sampled_acceptance is not None
            else None
        )
        self.spec_accept_floor = spec_accept_floor
        self.spec_draft_jpt = None
        self.loaded: Dict[str, bool] = {}

    def load_model(self, model: str) -> None:
        fresh = model not in self.loaded
        self.loaded[model] = True
        if fresh:
            try:
                from ..obs.flight import EV_MODEL_LOADED, FLIGHT, trace_attrs
                from ..obs.metrics import enabled as _enabled
                from ..obs.metrics import observe_model_loaded
                from ..obs.trace import TRACER

                if _enabled():
                    nbytes = self.model_bytes.get(model, 0)
                    observe_model_loaded(model, nbytes)
                    FLIGHT.emit(
                        EV_MODEL_LOADED,
                        model=model,
                        weight_bytes=nbytes,
                        **trace_attrs(TRACER.current()),
                    )
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def evict_model(self, model: str) -> bool:
        """Drop a simulated model's weights (the hermetic twin of the
        engine's LRU `_evict_weights` — CI forces an eviction through
        this and asserts `/api/ps` + the weight-lifecycle families
        reflect it). Returns False when the model was not loaded."""
        if self.loaded.pop(model, None) is None:
            return False
        try:
            from ..obs.flight import EV_MODEL_EVICTED, FLIGHT, trace_attrs
            from ..obs.metrics import enabled as _enabled
            from ..obs.metrics import observe_model_evicted
            from ..obs.trace import TRACER

            if _enabled():
                observe_model_evicted(model, "lru")
                FLIGHT.emit(
                    EV_MODEL_EVICTED,
                    model=model,
                    reason="lru",
                    **trace_attrs(TRACER.current()),
                )
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        return True

    def model_weight_bytes(self, model: str) -> int:
        """Simulated weight bytes (ctor ``model_bytes``). An
        UNCONFIGURED name raises — a constant default would make the
        fleet's size ordering silently alphabetical; raising makes it
        fall back to the fleet's configured order instead (first
        ``--models`` entry = smallest), which is the documented
        contract for backends that cannot estimate."""
        if model not in self.model_bytes:
            raise KeyError(f"no simulated weight bytes for {model!r}")
        return int(self.model_bytes[model])

    def loaded_models(self):
        return sorted(self.loaded)

    def models_debug_state(self) -> dict:
        """The weight-lifecycle `/debug/state` block, hermetic twin of
        the engine's (simulated bytes, no live-session refcounts — the
        fake has no weight LRU to guard)."""
        return {
            "loaded": {
                name: {
                    "weight_bytes": self.model_bytes.get(name),
                    "live_sessions": 0,
                    "joules_per_token": (
                        self.last_joules_per_token_by_model.get(name)
                    ),
                }
                for name in self.loaded_models()
            },
            "pinned": [],
        }

    def _result(self, request: GenerationRequest) -> GenerationResult:
        """The deterministic result, with no simulated wall time spent —
        shared by the blocking path (which sleeps around it) and the
        stepped sessions (which sleep per slice instead)."""
        if request.model not in self.loaded:
            self.load_model(request.model)
        digest = hashlib.sha256(
            f"{request.model}|{request.prompt}|{request.seed}".encode()
        ).digest()
        n = request.max_new_tokens
        tokens = [digest[i % len(digest)] + 3 for i in range(n)]
        decode_s = n / self.tokens_per_s
        prefill_s = 0.001
        text = "".join(chr(97 + (t % 26)) for t in tokens)
        return GenerationResult(
            request=request,
            tokens=tokens,
            text=text,
            prompt_tokens=len(request.prompt.encode("utf-8")) + 1,
            generated_tokens=n,
            prefill_s=prefill_s,
            decode_s=decode_s,
            total_s=prefill_s + decode_s,
        )

    def _jpt_for(self, model: str) -> float:
        """This model's synthetic J/token: the per-model figure when
        configured (multi-model fleets), else the backend-wide one."""
        return float(self.model_joules.get(model, self.joules_per_token))

    def _observe_energy(self, result: GenerationResult) -> None:
        """Record the configured synthetic J/token for one served result
        (no-op at the 0.0 default) — the fake twin of the real engine's
        ``_observe_result`` energy attribution, so llm_request_* energy
        families and extras["energy_model"] are CI-testable."""
        jpt = self._jpt_for(result.request.model)
        if not jpt or not _obs_enabled():
            return
        try:
            from ..obs import energy as obs_energy

            est = {
                "J": jpt * result.generated_tokens,
                "J_per_token": jpt,
            }
            obs_energy.observe_estimate(est)
            result.extras = {
                **(result.extras or {}),
                "energy_model": dict(est),
            }
            self.last_joules_per_token = jpt
            self.last_joules_per_token_by_model[result.request.model] = jpt
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def generate(self, request: GenerationRequest) -> GenerationResult:
        # a dead backend is dead on EVERY path: the continuous
        # scheduler's engine-death salvage re-runs tickets through this
        # blocking path, and a truly-dead engine must fail them there
        # too (that is what surfaces a mid-stream death as a terminal
        # stream error instead of a silent salvage)
        if self.fail_decode_open or self.fail_after_slices is not None:
            raise RuntimeError("fake backend died (simulated)")
        result = self._result(request)
        if self.simulate_delay:
            time.sleep(result.total_s)
        self._observe_energy(result)
        return result

    def decode_open(
        self,
        requests: List[GenerationRequest],
        reserve_rows: Optional[int] = None,
        slice_steps: Optional[int] = None,
        spec_accept_floor: Optional[float] = None,
    ) -> _FakeStepSession:
        """Stepped-decode protocol (see the module docstring);
        ``slice_steps`` is accepted for signature parity with the real
        engine (the fake session's step takes the width per call);
        ``spec_accept_floor`` overrides the backend's fallback floor per
        session, exactly like the real engine's decode_open."""
        if self.fail_decode_open:
            raise RuntimeError(
                "fake backend refused decode_open (simulated death)"
            )
        return _FakeStepSession(
            self,
            requests,
            max_rows=self.max_rows,
            spec_accept_floor=spec_accept_floor,
        )
