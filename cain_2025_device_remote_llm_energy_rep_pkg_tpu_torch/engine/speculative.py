"""Speculative decoding: a draft source proposes, the target verifies.

Counterpart of the JAX package's ``engine/speculative.py``. A draft source
proposes ``k`` tokens per row; ONE target forward scores each row's
``k+1`` candidate positions (``[last, d_1..d_k]``), reading the target's
weights once for up to ``k+1`` tokens; each row advances by its own
accepted prefix.

- **Greedy rows** (temperature < 1e-6) accept the longest prefix of drafts
  that equal the target's argmax, then emit the target's own token: the
  tokens are those of plain greedy decode.
- **Sampled rows**: rejection resampling (Leviathan et al. 2023). Draft
  ``x_j ~ q_j`` is accepted with probability ``min(1, p_j(x_j)/q_j(x_j))``
  over the *modified* distributions (``ops/sampling.py::modified_probs``);
  at the first rejection the token is drawn from the normalised residual
  ``max(p − q, 0)``, and at full acceptance from ``p`` itself (the same
  formula with ``q ≡ 0``). The emitted tokens are distributed as plain
  sampling from the target. Each row draws from its own
  ``torch.Generator``, per round in the JAX package's order: the ``k``
  proposal draws (model sources), ``k`` accept uniforms, one residual
  draw. Threefry and Philox streams differ, so sampled rows match the JAX
  package in distribution only.

Draft sources: :class:`ModelDraftSource` (a small model with its own
contiguous batch cache, per-row offsets), :class:`CrossModelDraftSource`
(the same mechanics, tagged as another lane's model) and
:class:`NgramDraftSource` (prompt lookup over the row's own history,
``q`` one-hot).

Two factories of step functions, as in the JAX package:

- :func:`build_spec_fn`, the solo greedy path (one request, contiguous
  caches at a scalar offset; the verify runs the plain masked attention,
  the drafts the engine's decode kernel);
- :func:`build_spec_step_fn`, the batched slice step of a stepped
  session over the paged pool in the stacked-hybrid layout: candidates
  land in the side caches and the prompt pages are read by the
  multi-query paged parts kernel. The scratch (kernel-less) and
  contiguous verify branches are not ported.

Where the JAX package runs the rounds inside one compiled
``while_loop``, the port runs them in a Python loop and reads the
done-mask on the host once per round.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.transformer import forward, logits_for
from ..ops.sampling import modified_probs, sample_token_per_row


class DraftSpec(NamedTuple):
    """A resolved speculative configuration: which draft source proposes
    for a target model, and how many tokens per round. ``draft`` is the
    draft model name for model/cross sources and ``None`` for ngram."""

    source: str  # "model" | "ngram" | "cross"
    draft: Optional[str]
    k: int


#: Longest suffix the n-gram matcher tries to match.
NGRAM_MAX = 3

# A temperature at or above this samples; below it is greedy.
_SAMPLED = 1e-6


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 of a [B, N] bool mask in
    which some entry of every row is True."""
    return torch.argmax(mask.to(torch.int32), dim=1)


def ngram_propose(
    hist: torch.Tensor,  # [B, H] prompt+generated history
    hlen: torch.Tensor,  # [B] valid length
    k: int,
    nmax: int = NGRAM_MAX,
) -> torch.Tensor:
    """Prompt-lookup draft proposals [B, k]: for each row, find the
    latest, longest (≤ ``nmax``) earlier occurrence of the history's
    current suffix and propose the ``k`` tokens that followed it. Rows
    with no match propose their last token repeated (the verify rejects
    per the target's own distribution, so a bad proposal costs
    acceptance, never correctness)."""
    b, h = hist.shape
    dev = hist.device
    pos = torch.arange(h, device=dev)
    hlen = hlen.to(torch.int64)
    # tail[:, j] = hist[hlen-1-j]: the suffix, newest token first
    tail = torch.stack(
        [torch.gather(hist, 1, torch.clamp(hlen[:, None] - 1 - j, min=0))[:, 0] for j in range(nmax)],
        dim=1,
    )
    # mlen[p] = longest match of the suffix ending at position p
    run = torch.ones((b, h), dtype=torch.bool, device=dev)
    mlen = torch.zeros((b, h), dtype=torch.int64, device=dev)
    for j in range(nmax):
        shifted = torch.roll(hist, j, dims=1)  # shifted[p] = hist[p-j]
        ok = (shifted == tail[:, j][:, None]) & (pos[None, :] >= j) & (hlen[:, None] > j)
        run = run & ok
        mlen = mlen + run.to(torch.int64)
    # exclude the trivial match at the current end (p == hlen-1) and
    # garbage past the valid length; prefer longer, then later matches
    valid = (pos[None, :] <= hlen[:, None] - 2) & (mlen > 0)
    score = torch.where(valid, mlen * (h + 1) + pos[None, :], torch.full_like(mlen, -1))
    best = torch.argmax(score, dim=1)
    found = torch.gather(score, 1, best[:, None])[:, 0] >= 0
    gidx = torch.minimum(
        best[:, None] + 1 + torch.arange(k, device=dev)[None, :],
        torch.clamp(hlen - 1, min=0)[:, None],
    )
    cand = torch.gather(hist, 1, gidx)
    last = torch.gather(hist, 1, torch.clamp(hlen[:, None] - 1, min=0))
    return torch.where(found[:, None], cand, last)


class ModelDraftSource:
    """A small autoregressive draft model. State: its contiguous batch
    cache ``[L, B, Hkv, T, D]`` (written in place) and per-row offsets;
    ``q`` is the draft's modified distribution at each proposal, the one
    :func:`sample_token_per_row` drew from."""

    name = "model"

    def __init__(
        self,
        dcfg,
        k: int,
        decode_attention=None,
        top_k: int = 0,
        use_top_p: bool = False,
        draft_temperature: Optional[float] = None,
    ):
        self.dcfg = dcfg
        self.k = k
        self.decode_attention = decode_attention
        self.top_k = top_k
        self.use_top_p = use_top_p
        # sampled rows draft at this temperature when set (q follows the
        # same chain, so the marginals stay the target's); greedy rows
        # keep greedy drafts
        self.draft_temperature = draft_temperature

    def _draft_temps(self, temps: List[float]) -> List[float]:
        if self.draft_temperature is None:
            return temps
        return [self.draft_temperature if t >= _SAMPLED else t for t in temps]

    def init_state(self, carry) -> Tuple[Any, ...]:
        return (carry["draft_offsets"], carry["draft_k"], carry["draft_v"])

    def carry_updates(self, state) -> dict:
        doffs, dk, dv = state
        return {"draft_offsets": doffs, "draft_k": dk, "draft_v": dv}

    def propose(self, draft, state, last, temps, top_ps, gens, need_q: bool):
        """k sequential draft steps, then one forward that seats d_k's K/V
        (a fully accepted round leaves no hole in the draft cache).
        Returns (drafts [B, k], q [B, k, V] or None, state); ``q`` is
        built only when ``need_q`` (some row samples)."""
        dcfg, k = self.dcfg, self.k
        doffs, dk, dv = state
        dtemps = self._draft_temps(temps)
        tok, offs = last, doffs
        drafts, dlogits = [], []
        for _ in range(k):
            hidden, _, _ = forward(
                draft.params, dcfg, tok[:, None], offs, dk, dv,
                self.decode_attention, layers=draft.layers,
            )
            lg = logits_for(draft.params, dcfg, hidden[:, 0])
            tok = sample_token_per_row(lg, gens, dtemps, self.top_k, top_ps)
            drafts.append(tok)
            if need_q:
                dlogits.append(lg)
            offs = offs + 1
        forward(draft.params, dcfg, tok[:, None], offs, dk, dv, self.decode_attention, layers=draft.layers)
        q = None
        if need_q:
            t = torch.tensor(dtemps, dtype=torch.float32, device=last.device)
            q = modified_probs(
                torch.stack(dlogits, dim=1), t[:, None, None], self.top_k,
                _top_p_tensor(top_ps, last.device)[:, None, None] if self.use_top_p else None,
            )
        return torch.stack(drafts, dim=1), q, state

    def advance(self, state, emit, m_eff, rows):
        doffs, dk, dv = state
        return (doffs + m_eff, dk, dv)


class CrossModelDraftSource(ModelDraftSource):
    """:class:`ModelDraftSource` whose draft weights are another serving
    lane's resident model; the distinct name tags it in the results."""

    name = "cross"


class NgramDraftSource:
    """Prompt-lookup drafting over the row's own history (``q`` one-hot;
    zero extra weights, zero extra forwards). State: the history buffer
    [B, H] and its valid lengths [B]."""

    name = "ngram"

    def __init__(self, k: int, nmax: int = NGRAM_MAX):
        self.k = k
        self.nmax = nmax

    def init_state(self, carry) -> Tuple[Any, ...]:
        return (carry["ngram_hist"], carry["ngram_len"])

    def carry_updates(self, state) -> dict:
        hist, hlen = state
        return {"ngram_hist": hist, "ngram_len": hlen}

    def propose(self, draft, state, last, temps, top_ps, gens, need_q: bool):
        hist, hlen = state
        return ngram_propose(hist, hlen, self.k, self.nmax), None, state

    def advance(self, state, emit, m_eff, rows):
        """Append each row's emitted tokens to its history; done rows and
        the rejected tail write nothing (nor past the buffer's end)."""
        hist, hlen = state
        idx = torch.arange(emit.shape[1], device=emit.device)
        wpos = hlen[:, None] + idx[None, :]
        keep = (idx[None, :] < m_eff[:, None]) & (wpos < hist.shape[1])
        hist[rows[:, None].expand_as(wpos)[keep], wpos[keep]] = emit[keep].to(hist.dtype)
        return (hist, hlen + m_eff)


def make_draft_source(
    source: str,
    dcfg,
    k: int,
    draft_decode_attention=None,
    top_k: int = 0,
    use_top_p: bool = False,
    draft_temperature: Optional[float] = None,
):
    """The draft source of a resolved spec (``draft_temperature`` only
    affects model/cross sources: n-gram proposals are deterministic)."""
    if source == "ngram":
        return NgramDraftSource(k)
    cls = CrossModelDraftSource if source == "cross" else ModelDraftSource
    return cls(
        dcfg, k, draft_decode_attention, top_k=top_k, use_top_p=use_top_p,
        draft_temperature=draft_temperature,
    )


def _top_p_tensor(top_ps: Optional[List[float]], device) -> torch.Tensor:
    """Per-row nucleus thresholds for :func:`modified_probs`; a row whose
    filter is off takes 2.0, which keeps every token (the JAX package's
    sentinel)."""
    return torch.tensor([p if p < 1.0 else 2.0 for p in top_ps], dtype=torch.float32, device=device)


def build_spec_fn(
    tcfg,
    dcfg,
    k: int,
    eos: int,
    decode_attention=None,
) -> Callable:
    """The solo greedy speculative loop for (target cfg, draft cfg, k)::

        spec(target, draft, first_token [1], start_offset, tkc, tvc,
             dkc, dvc, n_real) -> (tokens, n_emitted, rounds, accepted)

    ``target``/``draft`` are ``Transformer`` bundles. ``tokens`` are the
    emitted tokens after ``first_token``, each what target-greedy alone
    would produce. Drafts decode through ``decode_attention``; the verify
    forward runs the plain masked attention over the target's cache (the
    JAX package passes no prefill kernel here). The caches need
    ``start_offset + n_real + 2k + 2`` slots (a round can overshoot
    ``n_real`` by k and the draft seats one extra entry)."""

    def spec(target, draft, first_token, start_offset, tkc, tvc, dkc, dvc, n_real):
        last = first_token.reshape(1)
        off = int(start_offset)
        out: List[int] = []
        n_em = rounds = accepted = 0
        done = False
        while n_em < n_real and not done:
            tok, doff, drafts = last, off, []
            for _ in range(k):
                hidden, _, _ = forward(
                    draft.params, dcfg, tok[:, None], doff, dkc, dvc, decode_attention,
                    layers=draft.layers,
                )
                tok = torch.argmax(logits_for(draft.params, dcfg, hidden[:, 0]), dim=-1)
                drafts.append(tok)
                doff += 1
            forward(draft.params, dcfg, tok[:, None], doff, dkc, dvc, decode_attention, layers=draft.layers)
            ver = torch.cat([last, *drafts])[None, :]  # [1, k+1]
            hidden, _, _ = forward(target.params, tcfg, ver, off, tkc, tvc, layers=target.layers)
            tnext = torch.argmax(logits_for(target.params, tcfg, hidden[0]), dim=-1).tolist()
            d = torch.cat(drafts).tolist()
            # longest accepted prefix, then the target's own next token
            n_acc = 0
            while n_acc < k and d[n_acc] == tnext[n_acc]:
                n_acc += 1
            emit = d[:n_acc] + [tnext[n_acc]]
            m = n_acc + 1
            if eos in emit:  # clip the round at its first EOS
                m = emit.index(eos) + 1
                done = True
            # accepted-and-extracted drafts only
            accepted += min(n_acc, max(min(m, n_real - n_em), 0))
            out.extend(emit[:m])
            n_em += m
            rounds += 1
            off += m
            last = torch.tensor([emit[m - 1]], dtype=torch.long, device=first_token.device)
        return out, n_em, rounds, accepted

    return spec


def build_spec_step_fn(
    tcfg,
    dcfg,
    k: int,
    n_steps: int,
    eos: int,
    draft_decode_attention=None,
    decode_attention=None,
    source: str = "model",
    top_k: int = 0,
    use_top_p: bool = False,
    draft_temperature: Optional[float] = None,
) -> Callable:
    """The batched speculative slice step of a stepped session over the
    paged pool, stacked-hybrid layout::

        decode((target, draft), carry, n_real) -> (out [B, n_steps*(k+1)], n_row [B])

    ``carry`` is the session's state dict (``engine/stepped.py``), updated
    in place: ``tokens``/``offsets``/``prompt_lens``/``remaining``/
    ``done`` [B], the pool, ``table`` and side caches (side columns
    ``g_bucket + k``: a verify writes up to ``write_pos + k``), ``gens``
    (one generator per row) and the host ``knobs``; the source's state
    (``draft_k``/``draft_v``/``draft_offsets`` or ``ngram_hist``/
    ``ngram_len``); and the cumulative per-row counters ``spec_rounds``/
    ``spec_accepted``/``spec_drafted``/``spec_rejected``.

    Per round, for every row at once: k proposals from the source; ONE
    target forward over ``[last, d_1..d_k]`` at the rows' own offsets, its
    K/V landing in the side caches at ``write_pos..write_pos+k`` and the
    prompt pages read through ``decode_attention`` (the engine's paged
    parts callable, which takes the [B, k+1, Hq, D] block to the
    multi-query kernel); the per-row accept rule (greedy or sampled, by
    the row's temperature); an EOS clip inside the round and the row's
    budget cut. Done rows ride along at frozen positions no mask reads.
    Rejected candidates' side columns are overwritten by the next round."""
    idx_cpu = torch.arange(k + 1)
    out_w = n_steps * (k + 1)
    src = make_draft_source(
        source, dcfg, k, draft_decode_attention, top_k=top_k,
        use_top_p=use_top_p, draft_temperature=draft_temperature,
    )

    def decode(models, carry, n_real):
        target, draft = models
        last = carry["tokens"]
        b = last.shape[0]
        dev = last.device
        rows = torch.arange(b, device=dev)
        idx = idx_cpu.to(dev)[None, :]
        temps = carry["knobs"]["temperature"]
        top_ps = carry["knobs"]["top_p"] if use_top_p else None
        gens = carry["gens"]
        sampled = [t >= _SAMPLED for t in temps]
        need_q = any(sampled)
        if need_q:
            temps_t = torch.tensor(temps, dtype=torch.float32, device=dev)
            srow = torch.tensor(sampled, device=dev)
        plens = carry["prompt_lens"]
        offs, done, rem = carry["offsets"], carry["done"], carry["remaining"]
        sstate = src.init_state(carry)
        out = torch.full((b, out_w), eos, dtype=torch.long, device=dev)
        n_row = torch.zeros((b,), dtype=torch.long, device=dev)
        rnds, acc = carry["spec_rounds"], carry["spec_accepted"]
        drafted, rejected = carry["spec_drafted"], carry["spec_rejected"]
        i = 0
        while i < n_real and not bool(done.all()):
            live = ~done
            live_host = live.tolist() if need_q else None
            drafts, qdist, sstate = src.propose(draft, sstate, last, temps, top_ps, gens, need_q)
            ver = torch.cat([last[:, None], drafts], dim=1)  # [B, k+1]
            leaf = {"table": carry["table"], "write_pos": offs - plens, "prompt_lens": plens}
            kc = {**leaf, "pool": carry["pool"].k, "side": carry["side_k"]}
            vc = {**leaf, "pool": carry["pool"].v, "side": carry["side_v"]}
            hidden, _, _ = forward(
                target.params, tcfg, ver, offs, kc, vc, decode_attention, layers=target.layers
            )
            tlogits = logits_for(target.params, tcfg, hidden)  # [B, k+1, V]
            tnext = torch.argmax(tlogits, dim=-1)

            # greedy lane: longest accepted prefix, then the target's token
            stop = torch.cat(
                [drafts != tnext[:, :k], torch.ones((b, 1), dtype=torch.bool, device=dev)], dim=1
            )
            n_acc = _first_true(stop)
            drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            t_at = torch.gather(tnext, 1, n_acc[:, None])
            eos_t = torch.full_like(drafts_pad, eos)
            emit = torch.where(
                idx < n_acc[:, None], drafts_pad, torch.where(idx == n_acc[:, None], t_at, eos_t)
            )

            if need_q:
                # sampled lane: rejection resampling over the modified
                # distributions; q ≡ 0 pads slot k, so full acceptance
                # draws the target's own sample from the same formula
                vocab = tlogits.shape[-1]
                p_mod = modified_probs(
                    tlogits, temps_t[:, None, None], top_k,
                    _top_p_tensor(top_ps, dev)[:, None, None] if use_top_p else None,
                )  # [B, k+1, V]
                if qdist is None:  # a deterministic proposal: one-hot q
                    qdist = F.one_hot(drafts, vocab).to(torch.float32)
                p_d = torch.gather(p_mod[:, :k], 2, drafts[..., None])[..., 0]
                q_d = torch.gather(qdist, 2, drafts[..., None])[..., 0]
                ratio = p_d / torch.clamp(q_d, min=1e-20)
                draw = [r for r in range(b) if sampled[r] and live_host[r]]
                u = torch.ones((b, k), dtype=torch.float32, device=dev)
                for r in draw:
                    u[r] = torch.rand(k, generator=gens[r], device=dev)
                stop_s = torch.cat(
                    [~(u < torch.clamp(ratio, max=1.0)),
                     torch.ones((b, 1), dtype=torch.bool, device=dev)], dim=1,
                )
                n_acc_s = _first_true(stop_s)
                q_pad = torch.cat([qdist, torch.zeros_like(qdist[:, :1])], dim=1)
                at = n_acc_s[:, None, None].expand(b, 1, vocab)
                p_at = torch.gather(p_mod, 1, at)[:, 0]  # [B, V]
                res = torch.clamp(p_at - torch.gather(q_pad, 1, at)[:, 0], min=0.0)
                res = torch.where(res.sum(-1, keepdim=True) > 1e-9, res, p_at)
                chosen = torch.zeros((b,), dtype=torch.long, device=dev)
                for r in draw:
                    chosen[r] = torch.multinomial(res[r], 1, generator=gens[r])[0]
                emit_s = torch.where(
                    idx < n_acc_s[:, None], drafts_pad,
                    torch.where(idx == n_acc_s[:, None], chosen[:, None], eos_t),
                )
                n_acc = torch.where(srow, n_acc_s, n_acc)
                emit = torch.where(srow[:, None], emit_s, emit)

            m = n_acc + 1
            # clip each row's round at its first EOS (inclusive)
            is_eos = (emit == eos) & (idx < m[:, None])
            m = torch.where(is_eos.any(dim=1), torch.minimum(m, _first_true(is_eos) + 1), m)
            # per-row budget: a live row emits at most its remaining tokens
            m_eff = torch.where(live, torch.minimum(m, rem), torch.zeros_like(m))
            eos_in = (is_eos & (idx < m_eff[:, None])).any(dim=1)
            out[rows[:, None], n_row[:, None] + idx] = emit
            last_new = torch.gather(emit, 1, torch.clamp(m_eff - 1, min=0)[:, None])[:, 0]
            last = torch.where(m_eff > 0, last_new, last)
            n_row = n_row + m_eff
            rem = rem - m_eff
            done = done | eos_in | (rem <= 0)
            offs = offs + m_eff
            sstate = src.advance(sstate, emit, m_eff, rows)
            # accepted-and-extracted drafts only (EOS clips and budget
            # cuts discard the tail)
            rnds = rnds + live.to(rnds.dtype)
            acc = acc + torch.minimum(n_acc, m_eff)
            drafted = drafted + live.to(drafted.dtype) * k
            rejected = rejected + (live & (n_acc == 0)).to(rejected.dtype)
            i += 1
        carry.update(
            tokens=last, offsets=offs, done=done, remaining=rem,
            spec_rounds=rnds, spec_accepted=acc, spec_drafted=drafted, spec_rejected=rejected,
            **src.carry_updates(sstate),
        )
        return out, n_row

    return decode
