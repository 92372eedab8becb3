"""Poisson load generator: N clients, exponential inter-arrival, mixed
prompt/target lengths.

The serving story's claims (continuous vs window batching, budget-aware
admission) only mean something under STAGGERED arrivals — the pattern a
fleet of independent users actually produces — not the all-at-once
thread storms the older tests used. This module is the one source of
that workload shape:

- :func:`build_workload` — deterministic (seeded) arrival offsets +
  requests with mixed prompt/budget lengths; optionally HEAVY-TAILED
  (lognormal) prompt lengths — real prompt-length distributions are
  long-tailed, and the tail is exactly what stresses mid-flight
  admission (one long-prompt joiner vs everyone's inter-token latency);
- :func:`run_load` — drive any ``submit(request) -> result`` callable
  (a scheduler's ``submit``, a client's ``generate``) with real-clock
  arrivals on threads, returning per-request latency records;
- :func:`build_cancellations` + ``run_load(stream_submit=...)`` —
  seeded MID-STREAM CANCELLATION injection: a chosen fraction
  of requests stream and hang up after a drawn token count, exercising
  the server's disconnect-driven retirement; per-request deadlines
  (``deadline_ms``) ride the workload the same seeded way;
- :func:`summarize` — p50/p95 TTFT & completion, aggregate tokens/s,
  plus cancelled / deadline-exceeded counts next to the percentiles;
  with ``--slo 'ttft_p99_ms<=250,...'`` (the serve ``--slo`` grammar)
  the summary gains per-objective EXACT client-side attainment, split
  per tier / per model when a mix is active.

This is the PyTorch port's copy of ``scripts/poisson_load.py``: the same
draws for a seed, the same CLI and the same summary line, over the port's
fake backend, schedulers, model fleet and HTTP client. Used by
``scripts/torch_serve_metrics_smoke.py`` (staggered arrivals against the
fake-engine server) and ``chip_smoke.py`` (against a ``serve --backend
torch`` process on the GPU); the CLI below drives a LIVE server over
HTTP::

    python scripts/torch_poisson_load.py --url http://host:11434 \
        --model qwen2:1.5b -n 32 --mean-interarrival-ms 50

Exit 0 on success; prints one JSON summary line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import random
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (  # noqa: E402
    GenerationRequest,
    GenerationResult,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.trace import (  # noqa: E402
    TraceContext,
    mint_trace_id,
)

DEFAULT_PROMPTS = (
    "short prompt",
    "a somewhat longer prompt with more words in it",
    "the third prompt variant, medium length",
)
DEFAULT_BUDGETS = (8, 16, 48)


def lognormal_prompt_tokens(
    n: int,
    median: float = 48.0,
    sigma: float = 1.0,
    max_tokens: int = 1024,
    seed: int = 0,
) -> List[int]:
    """``n`` seeded HEAVY-TAILED prompt lengths, in tokens: lognormal
    with the given median (= exp(mu)) and shape ``sigma``, clamped to
    [1, max_tokens]. Deterministic for a (n, params, seed) tuple — the
    same trace replays across A/B arms. The generator is independent of
    the arrival-time stream (its own derived seed), so adding length
    draws does not perturb previously-seeded arrival offsets."""
    rng = random.Random((seed << 16) ^ 0x10C0)
    mu = math.log(max(median, 1.0))
    return [
        max(1, min(int(max_tokens), int(round(rng.lognormvariate(mu, sigma)))))
        for _ in range(n)
    ]


def parse_tier_mix(spec: str) -> Dict[str, float]:
    """``"high=0.2,low=0.8"`` → {"high": 0.2, "low": 0.8}. Tier names
    are serve/protocol.PRIORITY_TIERS keys or bare integers; fractions
    need not sum to 1 — the remainder draws "normal"."""
    out: Dict[str, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, eq, frac = entry.partition("=")
        if not eq:
            raise ValueError(
                f"tier mix entry {entry!r} is not name=fraction"
            )
        out[name.strip()] = float(frac)
    if sum(out.values()) > 1.0 + 1e-9:
        raise ValueError(f"tier mix fractions sum past 1: {spec!r}")
    return out


def draw_tiers(
    n: int, tier_mix: Optional[Dict[str, float]], seed: int = 0
) -> List[int]:
    """``n`` seeded priority tiers drawn from ``tier_mix`` (fraction
    mass not covered by the mix draws "normal"). Uses its own derived
    seed, so enabling tiers replays the SAME arrivals/lengths — the
    property the preemption bench's A/B arms depend on."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.protocol import (
        DEFAULT_PRIORITY,
        parse_priority,
    )

    if not tier_mix:
        return [DEFAULT_PRIORITY] * n
    rng = random.Random((seed << 16) ^ 0x71E5)
    names = sorted(tier_mix)
    tiers = []
    for _ in range(n):
        u, acc, drawn = rng.random(), 0.0, DEFAULT_PRIORITY
        for name in names:
            acc += tier_mix[name]
            if u < acc:
                drawn = parse_priority(name)
                break
        tiers.append(drawn)
    return tiers


def parse_model_mix(spec: str) -> Dict[str, float]:
    """``"small:1b=0.7,big:7b=0.3"`` → {"small:1b": 0.7, "big:7b": 0.3}.
    Model names may contain '=' -free colons (qwen2:1.5b); the LAST '='
    separates name from fraction. Fractions need not sum to 1 — the
    remainder draws the workload's default model (or "auto")."""
    out: Dict[str, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, eq, frac = entry.rpartition("=")
        if not eq or not name:
            raise ValueError(
                f"model mix entry {entry!r} is not model=fraction"
            )
        out[name.strip()] = float(frac)
    if sum(out.values()) > 1.0 + 1e-9:
        raise ValueError(f"model mix fractions sum past 1: {spec!r}")
    return out


def draw_models(
    n: int,
    model_mix: Optional[Dict[str, float]],
    default_model: str,
    seed: int = 0,
) -> List[str]:
    """``n`` seeded per-request model names drawn from ``model_mix``
    (uncovered fraction mass draws ``default_model``). Uses its own
    derived seed — INDEPENDENT of the arrival/length/tier streams, so
    turning the mix on replays the SAME trace: the property the
    multi-model fleet bench's A/B arms (fleet vs serialized vs
    always-big) depend on."""
    if not model_mix:
        return [default_model] * n
    rng = random.Random((seed << 16) ^ 0x30DE1)
    names = sorted(model_mix)
    models = []
    for _ in range(n):
        u, acc, drawn = rng.random(), 0.0, default_model
        for name in names:
            acc += model_mix[name]
            if u < acc:
                drawn = name
                break
        models.append(drawn)
    return models


def parse_temperature_dist(spec: str) -> Dict[float, float]:
    """``"0.7=0.6,1.0=0.2"`` → {0.7: 0.6, 1.0: 0.2}. Each entry is
    temperature=fraction; fractions need not sum to 1 — the remainder
    draws temperature 0.0 (greedy)."""
    out: Dict[float, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        temp, eq, frac = entry.partition("=")
        if not eq:
            raise ValueError(
                f"temperature dist entry {entry!r} is not temp=fraction"
            )
        out[float(temp)] = float(frac)
    if sum(out.values()) > 1.0 + 1e-9:
        raise ValueError(f"temperature fractions sum past 1: {spec!r}")
    if any(t < 0 for t in out):
        raise ValueError(f"negative temperature in {spec!r}")
    return out


def draw_temperatures(
    n: int, dist: Optional[Dict[float, float]], seed: int = 0
) -> List[float]:
    """``n`` seeded per-request temperatures drawn from ``dist``
    (uncovered fraction mass draws 0.0 — greedy). Uses its own derived
    seed, INDEPENDENT of the arrival/length/tier/model streams, so
    turning sampling on replays the SAME trace — the property the
    sampled-speculation A/B arms depend on: the spec-on and
    spec-off runs see identical arrivals and identical sampled/greedy
    row mixes."""
    if not dist:
        return [0.0] * n
    rng = random.Random((seed << 16) ^ 0x7E39)
    temps_sorted = sorted(dist)
    temps = []
    for _ in range(n):
        u, acc, drawn = rng.random(), 0.0, 0.0
        for t in temps_sorted:
            acc += dist[t]
            if u < acc:
                drawn = t
                break
        temps.append(drawn)
    return temps


def parse_tenant_mix(spec: str) -> Dict[str, float]:
    """``"a=0.7,b=0.3"`` → {"a": 0.7, "b": 0.3}. Tenant names are free
    strings (the wire's ``x_tenant``); fractions need not sum to 1 —
    the remainder draws "default", the unlabelled-traffic bucket the
    server's tenant table aggregates under the same name."""
    out: Dict[str, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, eq, frac = entry.rpartition("=")
        if not eq or not name:
            raise ValueError(
                f"tenant mix entry {entry!r} is not tenant=fraction"
            )
        out[name.strip()] = float(frac)
    if sum(out.values()) > 1.0 + 1e-9:
        raise ValueError(f"tenant mix fractions sum past 1: {spec!r}")
    return out


def draw_tenants(
    n: int, tenant_mix: Optional[Dict[str, float]], seed: int = 0
) -> List[str]:
    """``n`` seeded per-request tenant names drawn from ``tenant_mix``
    (uncovered fraction mass draws "default"). Uses its own derived
    seed, INDEPENDENT of the arrival/length/tier/model/temperature
    streams, so turning the mix on replays the SAME trace — the
    tenant-accounting A/B compares the per-tenant Joules
    split against a solo run of the identical arrivals."""
    if not tenant_mix:
        return ["default"] * n
    rng = random.Random((seed << 16) ^ 0x7E4A7)
    names = sorted(tenant_mix)
    tenants = []
    for _ in range(n):
        u, acc, drawn = rng.random(), 0.0, "default"
        for name in names:
            acc += tenant_mix[name]
            if u < acc:
                drawn = name
                break
        tenants.append(drawn)
    return tenants


def build_cancellations(
    n: int,
    cancel_frac: float,
    after_tokens: Tuple[int, int] = (4, 32),
    seed: int = 0,
) -> List[Optional[int]]:
    """Per-request cancellation plan: entry ``i`` is the token count
    after which client ``i`` hangs up mid-stream, or None (runs to
    completion). Seeded and independent of the arrival/length streams
    (its own derived seed), so turning cancellation on replays the SAME
    arrivals — the A/B the streaming_cancellation bench depends on.
    ``after_tokens`` is an inclusive uniform range."""
    rng = random.Random((seed << 16) ^ 0xCA7CE1)
    lo, hi = after_tokens
    return [
        rng.randint(int(lo), int(hi)) if rng.random() < cancel_frac else None
        for _ in range(n)
    ]


def synth_prompt(n_tokens: int) -> str:
    """A prompt that byte-tokenizes to ``n_tokens`` ids (BOS + one id
    per ASCII byte — models/tokenizer.ByteTokenizer)."""
    return "p" * max(1, n_tokens - 1)


def shared_prefix_texts(pool: int, prefix_tokens: int) -> List[str]:
    """``pool`` distinct system-prompt texts, each byte-tokenizing to
    ``prefix_tokens`` ids (BOS + one id per char). Members differ in
    their first bytes (``<sysK>``), so prompts drawn from different
    pool members never share a usable prefix — the trace models a
    server fronting ``pool`` distinct applications."""
    out = []
    for k in range(pool):
        head = f"<sys{k}>"
        body = max(0, prefix_tokens - 1 - len(head))
        out.append(head + "s" * body)
    return out


def build_workload(
    n: int,
    mean_interarrival_s: float,
    seed: int = 0,
    model: str = "qwen2:1.5b",
    prompts: Sequence[str] = DEFAULT_PROMPTS,
    budgets: Sequence[int] = DEFAULT_BUDGETS,
    stop_at_eos: bool = True,
    prompt_len_dist: Optional[str] = None,  # None/"fixed" | "lognormal"
    prompt_len_median: float = 48.0,
    prompt_len_sigma: float = 1.0,
    prompt_len_max: int = 1024,
    anchor_longest: bool = False,
    deadline_ms: Optional[float] = None,
    shared_prefix_frac: float = 0.0,
    prefix_pool: int = 1,
    shared_prefix_tokens: int = 192,
    anchor_shared_prefix: bool = False,
    tier_mix: Optional[Dict[str, float]] = None,
    model_mix: Optional[Dict[str, float]] = None,
    temperature_dist: Optional[Dict[float, float]] = None,
    tenant_mix: Optional[Dict[str, float]] = None,
) -> List[Tuple[float, GenerationRequest]]:
    """``[(arrival_offset_s, request), ...]`` — Poisson arrivals (seeded
    exponential inter-arrival; the first request arrives at t=0) over a
    deterministic rotation of mixed prompt and budget lengths.

    ``prompt_len_dist="lognormal"`` replaces the prompt rotation with
    per-request synthetic prompts whose TOKEN lengths draw from a seeded
    heavy-tailed lognormal (:func:`lognormal_prompt_tokens`).
    ``anchor_longest`` swaps the longest draw to request 0: the first
    arrival anchors a continuous decode session and its prompt bucket
    sizes the session's cache, so capacity-feasibility of later joins is
    held constant while the JOIN policy under test varies.
    ``deadline_ms`` stamps every request with that per-request deadline
    (scheduler-enforced: pre-admission rejection + mid-flight
    retirement).

    ``shared_prefix_frac`` models the paper's many-clients-one-server
    shape: that fraction of requests (seeded, independent of
    the arrival/length streams) carries one of ``prefix_pool`` distinct
    ``shared_prefix_tokens``-token system prompts in front of its own
    (always-unique) tail — the workload shared-prefix CoW paging is
    built for. A/B arms replay the SAME trace because the share draws
    use their own derived seed.

    ``tier_mix`` (:func:`parse_tier_mix`'s shape) stamps each
    request with a seeded SLO tier — the priority-class traffic the
    preemption bench A/Bs; the tier stream is independent of arrivals/
    lengths, so the same trace replays across policy arms.

    ``model_mix`` (:func:`parse_model_mix`'s shape) assigns
    each request a seeded MODEL — the mixed-model traffic the
    multi-model fleet serves concurrently (uncovered fraction mass
    draws the ``model`` default, which may be "auto" for policy-routed
    traffic). The model stream is independent of arrivals/lengths/
    tiers, so the same trace replays across fleet-vs-serialized arms;
    the summary gains a per-model percentile breakdown + escalation
    counts.

    ``temperature_dist`` (:func:`parse_temperature_dist`'s
    shape) stamps each request with a seeded TEMPERATURE — the
    sampled/greedy traffic mix the sampled-speculation path serves
    (uncovered fraction mass draws 0.0, greedy). The temperature stream
    is independent of every other stream, so the same trace replays
    across spec-on/spec-off arms; the summary gains a sampled/greedy
    split.

    ``tenant_mix`` (:func:`parse_tenant_mix`'s shape) stamps
    each request with a seeded TENANT (the wire ``x_tenant``; uncovered
    fraction mass draws "default"). Independent of every other stream,
    so the same trace replays with tenancy on or off; the summary gains
    a per-tenant percentile + Joules breakdown cross-checkable against
    the server's ``GET /debug/tenants``.

    Every request additionally carries a CALLER-MINTED ``x_trace``:
    the summary prints the trace ids of failed / retried /
    SLO-missed requests, so a bad run is immediately queryable via the
    router's ``GET /debug/timeline?trace=`` (or any replica's
    ``/debug/flight?trace=``) without re-running anything."""
    rng = random.Random(seed)
    tiers = draw_tiers(n, tier_mix, seed=seed)
    models = draw_models(n, model_mix, model, seed=seed)
    temps = draw_temperatures(n, temperature_dist, seed=seed)
    tenants = draw_tenants(n, tenant_mix, seed=seed)
    share_rng = random.Random((seed << 16) ^ 0x5F1C)
    prefixes = (
        shared_prefix_texts(max(1, prefix_pool), shared_prefix_tokens)
        if shared_prefix_frac > 0
        else []
    )
    prompt_list: Optional[List[str]] = None
    if prompt_len_dist == "lognormal":
        lens = lognormal_prompt_tokens(
            n,
            median=prompt_len_median,
            sigma=prompt_len_sigma,
            max_tokens=prompt_len_max,
            seed=seed,
        )
        if anchor_longest and lens:
            i_max = lens.index(max(lens))
            lens[0], lens[i_max] = lens[i_max], lens[0]
        prompt_list = [synth_prompt(t) for t in lens]
    elif prompt_len_dist not in (None, "fixed"):
        raise ValueError(
            f"unknown prompt_len_dist {prompt_len_dist!r} "
            "(expected None, 'fixed' or 'lognormal')"
        )
    out: List[Tuple[float, GenerationRequest]] = []
    t = 0.0
    for i in range(n):
        if i:
            t += rng.expovariate(1.0 / mean_interarrival_s)
        prompt = (
            prompt_list[i]
            if prompt_list is not None
            else prompts[i % len(prompts)]
        )
        shares = prefixes and share_rng.random() < shared_prefix_frac
        if prefixes and i == 0 and anchor_shared_prefix:
            # request 0 anchors the continuous session, and a session
            # anchor's prompt pages are what later sharers MAP — pin it
            # to pool member 0 so the hot prefix is always page-backed
            # (the share_rng draw above is still consumed, keeping the
            # rest of the trace identical either way)
            prompt = prefixes[0] + f" q{i} " + prompt
        elif shares:
            # unique per-request marker after the shared prefix so two
            # sharers always DIVERGE (the CoW boundary under test)
            prompt = (
                prefixes[share_rng.randrange(len(prefixes))]
                + f" q{i} " + prompt
            )
        out.append(
            (
                t,
                GenerationRequest(
                    models[i],
                    prompt,
                    max_new_tokens=budgets[i % len(budgets)],
                    temperature=temps[i],
                    seed=i,
                    stop_at_eos=stop_at_eos,
                    deadline_ms=deadline_ms,
                    priority=tiers[i],
                    tenant=tenants[i],
                    trace=TraceContext(trace_id=mint_trace_id()),
                ),
            )
        )
    return out


def run_load(
    submit: Callable[[GenerationRequest], GenerationResult],
    workload: List[Tuple[float, GenerationRequest]],
    stream_submit: Optional[Callable] = None,
    cancellations: Optional[List[Optional[int]]] = None,
) -> List[Dict]:
    """Replay ``workload`` against ``submit`` with real-clock arrival
    offsets, one thread per request (the N-independent-clients model).
    Each record carries client-side completion and, when the scheduler
    attached them (``extras["sched"]``), server-side TTFT/completion.

    With ``stream_submit`` (a callable returning an iterator of
    chunk-like objects with ``tokens``/``done``/``result`` — a client's
    ``generate_stream``, or :func:`channel_chunks` over a scheduler's
    ``submit_stream``) and a :func:`build_cancellations` plan, planned
    requests STREAM and close the iterator after their drawn token
    count — the wire-level disconnect that triggers server-side
    retirement. Their records carry ``cancelled=True``, the tokens
    actually delivered, and a client-side TTFT-at-first-chunk."""
    records: List[Optional[Dict]] = [None] * len(workload)
    start = time.monotonic()

    def client(i: int, offset: float, request: GenerationRequest) -> None:
        delay = start + offset - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t_submit = time.monotonic()
        rec: Dict = {
            "offset_s": offset,
            "t_submit": t_submit - start,
            "tier": getattr(request, "priority", None),
            # sampled/greedy attribution: the summary splits
            # figures by whether the row decoded at temperature > 0
            "temperature": getattr(request, "temperature", 0.0),
            # the model the CALLER asked for ("auto" included); the
            # fleet's resolved model overwrites this at completion so
            # the per-model breakdown attributes to who actually ran
            "model": request.model,
            # tenant attribution: the summary's per-tenant
            # Joules/percentile split keys on this stamp, and the
            # /debug/tenants cross-check sums records by it
            "tenant": getattr(request, "tenant", None) or "default",
            # the caller-minted wire trace: carried on every
            # record so the summary can name WHICH requests went wrong
            "trace": (
                request.trace.trace_id
                if getattr(request, "trace", None) is not None
                else None
            ),
        }
        cancel_after = cancellations[i] if cancellations else None
        try:
            if cancel_after is not None and stream_submit is not None:
                self_cancelled, tokens, t_first, result = _consume_stream(
                    stream_submit(request), cancel_after
                )
                t_done = time.monotonic()
                if self_cancelled:
                    rec.update(
                        cancelled=True,
                        tokens=tokens,
                        ttft_s=(
                            t_first - t_submit if t_first is not None else None
                        ),
                        completion_s=t_done - t_submit,
                        t_done=t_done - start,
                    )
                    records[i] = rec
                    return
                # finished before the cancel point: a normal completion
                _record_result(rec, result, t_submit, t_done, start)
            else:
                result = submit(request)
                _record_result(
                    rec, result, t_submit, time.monotonic(), start
                )
        except BaseException as exc:  # noqa: BLE001
            rec["error"] = f"{type(exc).__name__}: {exc}"
        records[i] = rec

    threads = [
        threading.Thread(target=client, args=(i, off, req), daemon=True)
        for i, (off, req) in enumerate(workload)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r for r in records if r is not None]


def _record_result(rec, result, t_submit, t_done, start) -> None:
    sched = (result.extras or {}).get("sched", {})
    router = (result.extras or {}).get("router", {})
    fleet = (result.extras or {}).get("fleet", {})
    # multi-model fleet attribution: the RESOLVED model (an
    # "auto" request's policy pick, or the cascade's escalation target)
    rec["model"] = result.request.model
    if fleet.get("escalated"):
        rec["escalated_from"] = fleet.get("escalated_from")
    rec.update(
        tokens=result.generated_tokens,
        completion_s=t_done - t_submit,
        ttft_s=sched.get("ttft_s"),
        sched_completion_s=sched.get("completion_s"),
        joined=sched.get("joined"),
        join_chunks=sched.get("join_chunks"),
        preempted=sched.get("preempted"),
        resumed=sched.get("resumed"),
        t_done=t_done - start,
    )
    # replica attribution: stamped by the front-door router
    # (extras.router) or by the --targets mode below — either way
    # the summary can split figures per replica
    if router.get("replica") is not None:
        rec["replica"] = router["replica"]
        if router.get("retried"):
            rec["retried"] = router["retried"]
        # prefix-affinity attribution: a "hit" rode the
        # estimator's longest-match claim to a warm replica; anything
        # else under --route-policy affinity degraded to least-queue
        aff = router.get("affinity")
        if isinstance(aff, dict):
            rec["affinity"] = "hit"
            rec["affinity_tokens"] = int(aff.get("est_tokens") or 0)
        elif aff is not None:
            rec["affinity"] = str(aff)
        # fleet-role attribution: the role of the replica
        # that FINISHED the row — a disagg-migrated row lands on its
        # decode side, so the per-role breakdown reads where tokens
        # actually streamed from
        if router.get("role") is not None:
            rec["role"] = router["role"]
    if sched.get("migrated"):
        rec["migrated"] = True
    # per-request energy attribution when the serving path computed one
    # (window/solo scheduling): the client-side joules_per_token SLO
    # check reads this
    energy = (result.extras or {}).get("energy_model") or {}
    if energy.get("J_per_token") is not None:
        rec["j_per_token"] = energy["J_per_token"]
    # total modelled Joules for the request: the per-tenant
    # Joules breakdown sums these, and the /debug/tenants cross-check
    # compares that sum against the server's own ledger
    if energy.get("J") is not None:
        rec["joules"] = energy["J"]


def _consume_stream(chunks, cancel_after: int):
    """Drain a chunk iterator until ``cancel_after`` tokens arrived,
    then close it (the disconnect). Returns (cancelled, tokens_seen,
    t_first_chunk, result-or-None)."""
    tokens = 0
    t_first = None
    result = None
    try:
        for chunk in chunks:
            if getattr(chunk, "done", False):
                result = chunk.result
                return False, tokens, t_first, result
            if chunk.tokens:
                if t_first is None:
                    t_first = time.monotonic()
                tokens += len(chunk.tokens)
            if tokens >= cancel_after:
                return True, tokens, t_first, None
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()
    # stream ended without a done record (server already saw the cancel)
    return True, tokens, t_first, None


def channel_chunks(channel):
    """Adapt a scheduler egress channel (serve/stream.py TokenStream)
    to the chunk-iterator protocol ``run_load``'s cancellation path
    drives: closing the generator cancels the channel, mirroring an
    HTTP client hanging up."""
    import types

    def gen():
        finished = False
        try:
            for event in channel.events():
                if event.kind == "delta":
                    yield types.SimpleNamespace(
                        tokens=event.tokens, done=False, result=None
                    )
                elif event.kind == "done":
                    finished = True
                    yield types.SimpleNamespace(
                        tokens=[], done=True, result=event.result
                    )
                else:
                    finished = True
                    raise event.error
        finally:
            if not finished:
                channel.cancel()

    return gen()


def session_segments(
    workload: List[Tuple[float, GenerationRequest]], sessions: int
) -> List[List[Tuple[float, GenerationRequest]]]:
    """Split one seeded trace into ``sessions`` contiguous SESSION
    segments (arrival offsets re-based to each segment's start). The
    script runs each segment through a FRESH scheduler over the SAME
    backend — the scheduler-restart shape the prefix store
    must survive: requests in segment k+1 can only hit prefixes via
    the engine store, never via session state."""
    if sessions <= 1 or not workload:
        return [workload]
    per = -(-len(workload) // sessions)
    out = []
    for i in range(0, len(workload), per):
        chunk = workload[i : i + per]
        base = chunk[0][0]
        out.append([(off - base, req) for off, req in chunk])
    return out


def prefix_store_counters() -> Dict[str, float]:
    """Snapshot of the prefix-store metric families (the script reports
    the before/after DELTA as the summary's ``prefix_store`` block)."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.prefix import (
        PREFIX_HIT_TOKENS_C,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.radix_store import (
        STORE_EVICTIONS_C,
        STORE_HITS_C,
        STORE_RESTORES_C,
        STORE_SPILLS_C,
    )

    return {
        "hit_tokens": PREFIX_HIT_TOKENS_C.labels().value,
        "hits": STORE_HITS_C.labels().value,
        "spills": STORE_SPILLS_C.labels().value,
        "restores": STORE_RESTORES_C.labels().value,
        "evictions": STORE_EVICTIONS_C.labels().value,
    }


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    k = min(len(ordered) - 1, max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
    return ordered[k]


def _objective_values(obj, recs: List[Dict]) -> Optional[List[float]]:
    """The client-side observations matching one SLO objective's family
    (None when the objective is not observable from the client — e.g.
    queue_wait lives inside the scheduler)."""
    if obj.family == "llm_request_ttft_seconds":
        return [r["ttft_s"] for r in recs if r.get("ttft_s") is not None]
    if obj.family == "llm_request_completion_seconds":
        return [
            r["completion_s"]
            for r in recs
            if r.get("completion_s") is not None and not r.get("cancelled")
        ]
    if obj.family == "llm_request_joules_per_token":
        return [
            r["j_per_token"] for r in recs if r.get("j_per_token") is not None
        ]
    return None


def slo_block(objectives, recs: List[Dict]) -> Dict:
    """Per-objective EXACT attainment over a record subset:
    the client-side cross-check of the server's bucket-interpolated
    estimate, from the same ``--slo`` grammar (``obs.slo``)."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.slo import (
        exact_attainment,
    )

    ok = [r for r in recs if "error" not in r]
    block = {}
    for obj in objectives:
        values = _objective_values(obj, ok)
        if values is None:
            block[obj.name] = {
                "spec": obj.raw,
                "attainment": None,
                "note": "not client-observable",
            }
            continue
        att = exact_attainment(obj, values)
        entry: Dict = {
            "spec": obj.raw,
            "requests": len(values),
            "attainment": None if att is None else round(att, 6),
        }
        if att is not None:
            entry["met"] = att >= obj.target
        block[obj.name] = entry
    return block


def summarize(records: List[Dict], slo=None) -> Dict:
    ok = [r for r in records if "error" not in r]
    completed = [r for r in ok if not r.get("cancelled")]
    cancelled = [r for r in ok if r.get("cancelled")]
    errors = [r for r in records if "error" in r]
    # a shed deadline is an OUTCOME of the workload, not a failure of
    # the harness: count it on its own next to the percentiles
    deadline_exceeded = [
        r for r in errors
        if "DeadlineExceeded" in r["error"] or "504" in r["error"]
    ]
    completions = [r["completion_s"] for r in completed]
    ttfts = [r["ttft_s"] for r in ok if r.get("ttft_s") is not None]
    tokens = sum(r["tokens"] for r in ok)  # delivered incl. partial streams
    span = (
        max(r["t_done"] for r in ok) - min(r["t_submit"] for r in ok)
        if ok
        else 0.0
    )
    out = {
        "requests": len(records),
        "errors": len(errors) - len(deadline_exceeded),
        "cancelled": len(cancelled),
        "deadline_exceeded": len(deadline_exceeded),
        "tokens": tokens,
        "agg_tokens_per_s": round(tokens / span, 2) if span > 0 else None,
        "completion_p50_s": round(percentile(completions, 50), 4),
        "completion_p95_s": round(percentile(completions, 95), 4),
    }
    if ttfts:
        out["ttft_p50_s"] = round(percentile(ttfts, 50), 4)
        out["ttft_p95_s"] = round(percentile(ttfts, 95), 4)
        out["ttft_p99_s"] = round(percentile(ttfts, 99), 4)
    preempted = [r for r in ok if r.get("preempted")]
    if preempted:
        out["preempted"] = len(preempted)
        out["resumed"] = sum(1 for r in preempted if r.get("resumed"))
    # per-replica attribution: present whenever records
    # carry a replica stamp — from a router's extras.router or the
    # --targets mode — so fleet benches and single-mesh benches
    # read one summary shape
    replicas = sorted(
        {r["replica"] for r in ok if r.get("replica") is not None}
    )
    if replicas:
        per = {}
        for name in replicas:
            r_recs = [r for r in ok if r.get("replica") == name]
            r_tokens = sum(r["tokens"] for r in r_recs)
            r_ttfts = [
                r["ttft_s"] for r in r_recs if r.get("ttft_s") is not None
            ]
            entry = {
                "requests": len(r_recs),
                "tokens": r_tokens,
                "share": round(r_tokens / tokens, 4) if tokens else None,
            }
            if r_ttfts:
                entry["ttft_p50_s"] = round(percentile(r_ttfts, 50), 4)
            # affinity breakdown: how many of this replica's
            # tickets the prefix estimator routed, the tokens its
            # longest-match claims covered, and how many landed here
            # via the least-queue degradation instead
            hits = [r for r in r_recs if r.get("affinity") == "hit"]
            if hits:
                entry["affinity_routed"] = len(hits)
                entry["prefix_hit_tokens"] = sum(
                    r.get("affinity_tokens") or 0 for r in hits
                )
            falls = sum(
                1 for r in r_recs if r.get("affinity") == "fallback"
            )
            if falls:
                entry["affinity_fallbacks"] = falls
            per[name] = entry
        out["replicas"] = per
        retried = sum(1 for r in ok if r.get("retried"))
        if retried:
            out["retried"] = retried
    # disagg migration attribution: rows that prefilled on
    # one replica and streamed from another — the count says how much
    # of the trace actually exercised the transfer path
    migrated = sum(1 for r in ok if r.get("migrated"))
    if migrated:
        out["migrated"] = migrated
    # per-role percentile breakdown: present when a role
    # fleet answered (any stamped role beyond plain "mixed") — the
    # prefill/decode split of the SAME figures the per-replica block
    # carries, so a disagg A/B reads TTFT-by-role from one summary
    roles = sorted({r["role"] for r in ok if r.get("role") is not None})
    if roles and (len(roles) > 1 or roles != ["mixed"]):
        by_role = {}
        for name in roles:
            rl_recs = [r for r in ok if r.get("role") == name]
            rl_done = [r for r in rl_recs if not r.get("cancelled")]
            rl_ttfts = [
                r["ttft_s"] for r in rl_recs if r.get("ttft_s") is not None
            ]
            rl_comps = [r["completion_s"] for r in rl_done]
            entry = {
                "requests": len(rl_recs),
                "tokens": sum(r["tokens"] for r in rl_recs),
                "migrated": sum(1 for r in rl_recs if r.get("migrated")),
                "completion_p50_s": round(percentile(rl_comps, 50), 4),
                "completion_p95_s": round(percentile(rl_comps, 95), 4),
            }
            if rl_ttfts:
                entry["ttft_p50_s"] = round(percentile(rl_ttfts, 50), 4)
                entry["ttft_p95_s"] = round(percentile(rl_ttfts, 95), 4)
                entry["ttft_p99_s"] = round(percentile(rl_ttfts, 99), 4)
            by_role[name] = entry
        out["roles"] = by_role
    # Trace forensics: the trace ids of every request that
    # went wrong — paste one into the router's GET /debug/timeline?trace=
    # (or a replica's /debug/flight?trace=) to replay its whole
    # cross-process story. Capped so one summary line stays one line.
    def _traces(recs, cap=16):
        ids = [r["trace"] for r in recs if r.get("trace")]
        return ids[:cap]

    failed_traces = _traces(
        [r for r in errors if r not in deadline_exceeded]
    )
    if failed_traces:
        out["failed_traces"] = failed_traces
    deadline_traces = _traces(deadline_exceeded)
    if deadline_traces:
        out["slo_missed_traces"] = deadline_traces
    retried_traces = _traces([r for r in ok if r.get("retried")])
    if retried_traces:
        out["retried_traces"] = retried_traces
    # per-model breakdown: mixed-model traffic's percentiles
    # split by the model that ACTUALLY answered (an auto request counts
    # on its resolved model), plus the small-first cascade's escalation
    # count — the summary shape the model_fleet bench A/Bs read
    models = sorted(
        {r.get("model") for r in ok if r.get("model") is not None}
    )
    if len(models) > 1:
        by_model = {}
        for name in models:
            m_recs = [r for r in ok if r.get("model") == name]
            m_done = [r for r in m_recs if not r.get("cancelled")]
            m_ttfts = [
                r["ttft_s"] for r in m_recs if r.get("ttft_s") is not None
            ]
            m_comps = [r["completion_s"] for r in m_done]
            entry = {
                "requests": len(m_recs),
                "tokens": sum(r["tokens"] for r in m_recs),
                "completion_p50_s": round(percentile(m_comps, 50), 4),
                "completion_p95_s": round(percentile(m_comps, 95), 4),
            }
            if m_ttfts:
                entry["ttft_p50_s"] = round(percentile(m_ttfts, 50), 4)
                entry["ttft_p95_s"] = round(percentile(m_ttfts, 95), 4)
                entry["ttft_p99_s"] = round(percentile(m_ttfts, 99), 4)
            if slo:
                entry["slo"] = slo_block(slo, m_recs)
            by_model[name] = entry
        out["models"] = by_model
    escalated = sum(1 for r in ok if r.get("escalated_from"))
    if escalated:
        out["escalations"] = escalated
    # sampled/greedy split: mixed-temperature traffic is the
    # workload sampled speculation serves — the split shows whether the
    # sampled rows' latency kept pace with the greedy rows' under one
    # continuous session (the rejection-resampling lane's whole point)
    sampled = [r for r in ok if (r.get("temperature") or 0.0) > 0]
    greedy = [r for r in ok if not (r.get("temperature") or 0.0) > 0]
    if sampled and greedy:
        sampling = {}
        for name, recs in (("sampled", sampled), ("greedy", greedy)):
            s_done = [r for r in recs if not r.get("cancelled")]
            s_ttfts = [
                r["ttft_s"] for r in recs if r.get("ttft_s") is not None
            ]
            s_comps = [r["completion_s"] for r in s_done]
            entry = {
                "requests": len(recs),
                "tokens": sum(r["tokens"] for r in recs),
                "completion_p50_s": round(percentile(s_comps, 50), 4),
                "completion_p95_s": round(percentile(s_comps, 95), 4),
            }
            if s_ttfts:
                entry["ttft_p50_s"] = round(percentile(s_ttfts, 50), 4)
                entry["ttft_p95_s"] = round(percentile(s_ttfts, 95), 4)
            sampling[name] = entry
        out["sampling"] = sampling
    # per-tier breakdown: the high-tier TTFT tail under
    # overload is THE number the preemption A/B trades for — reported
    # per tier so one summary line carries both sides of the trade
    tiers = sorted({r.get("tier") for r in records if r.get("tier") is not None})
    if len(tiers) > 1:
        by_tier = {}
        for tier in tiers:
            t_recs = [r for r in records if r.get("tier") == tier]
            t_ok = [r for r in t_recs if "error" not in r]
            t_done = [r for r in t_ok if not r.get("cancelled")]
            t_ttfts = [
                r["ttft_s"] for r in t_ok if r.get("ttft_s") is not None
            ]
            t_comps = [r["completion_s"] for r in t_done]
            entry = {
                "requests": len(t_recs),
                "errors": len(t_recs) - len(t_ok),
                "completion_p50_s": round(percentile(t_comps, 50), 4),
                "completion_p95_s": round(percentile(t_comps, 95), 4),
            }
            if t_ttfts:
                entry["ttft_p50_s"] = round(percentile(t_ttfts, 50), 4)
                entry["ttft_p95_s"] = round(percentile(t_ttfts, 95), 4)
                entry["ttft_p99_s"] = round(percentile(t_ttfts, 99), 4)
            t_pre = [r for r in t_ok if r.get("preempted")]
            if t_pre:
                entry["preempted"] = len(t_pre)
            if slo:
                entry["slo"] = slo_block(slo, t_recs)
            by_tier[str(tier)] = entry
        out["tiers"] = by_tier
    # per-tenant breakdown: the same percentile shape split
    # by the tenant stamp, plus the Joules the serving path attributed
    # to each tenant's rows (slice-level attribution summed over this
    # tenant's completed requests). The totals are the CLIENT-side half
    # of the /debug/tenants cross-check: the server's table must agree
    # with these by-hand sums.
    tenants = sorted(
        {r.get("tenant") for r in records if r.get("tenant") is not None}
    )
    if len(tenants) > 1 or (tenants and tenants != ["default"]):
        by_tenant = {}
        for name in tenants:
            tn_recs = [r for r in records if r.get("tenant") == name]
            tn_ok = [r for r in tn_recs if "error" not in r]
            tn_done = [r for r in tn_ok if not r.get("cancelled")]
            tn_ttfts = [
                r["ttft_s"] for r in tn_ok if r.get("ttft_s") is not None
            ]
            tn_comps = [r["completion_s"] for r in tn_done]
            tn_tokens = sum(r["tokens"] for r in tn_ok)
            tn_joules = [r["joules"] for r in tn_ok if r.get("joules")]
            entry = {
                "requests": len(tn_recs),
                "errors": len(tn_recs) - len(tn_ok),
                "cancelled": len(tn_ok) - len(tn_done),
                "tokens": tn_tokens,
                "completion_p50_s": round(percentile(tn_comps, 50), 4),
                "completion_p95_s": round(percentile(tn_comps, 95), 4),
            }
            if tn_ttfts:
                entry["ttft_p50_s"] = round(percentile(tn_ttfts, 50), 4)
                entry["ttft_p95_s"] = round(percentile(tn_ttfts, 95), 4)
            if tn_joules:
                j_sum = sum(tn_joules)
                entry["joules"] = round(j_sum, 6)
                done_tokens = sum(
                    r["tokens"] for r in tn_ok if r.get("joules")
                )
                if done_tokens:
                    entry["j_per_token"] = round(j_sum / done_tokens, 6)
            if slo:
                entry["slo"] = slo_block(slo, tn_recs)
            by_tenant[name] = entry
        out["tenants"] = by_tenant
    # client-side SLO attainment: EXACT per-objective
    # fractions over the raw records — the cross-check against the
    # server's /debug/timeseries bucket estimate
    if slo:
        out["slo"] = slo_block(slo, records)
    return out


def _tenants_server_view(args) -> Optional[Dict]:
    """The server-side tenant table for the cross-check: the in-process
    obs.tenants snapshot under --fake (the scheduler accounted into
    this process's table), or a best-effort ``GET /debug/tenants`` from
    --url / each --targets replica. None when unavailable (telemetry
    disabled → the endpoint 404s; the summary simply omits the block)."""
    if args.fake:
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs import (
            tenants as obs_tenants,
        )
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.metrics import (
            enabled as obs_enabled,
        )

        return obs_tenants.snapshot() if obs_enabled() else None
    import urllib.request

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.protocol import (
        DEBUG_TENANTS_PATH,
    )

    def fetch(base: str) -> Optional[Dict]:
        url = base if base.startswith("http") else f"http://{base}"
        try:
            with urllib.request.urlopen(
                url + DEBUG_TENANTS_PATH, timeout=5.0
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — cross-check is best-effort
            return None
    if args.targets:
        views = {
            name: fetch(name)
            for name in args.targets.split(",")
            if name
        }
        return views if any(v is not None for v in views.values()) else None
    return fetch(args.url) if args.url else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", help="live server base URL (http://host:port)")
    ap.add_argument(
        "--targets",
        help="comma-separated replica servers (host:port[,host:port...]): "
        "drive ONE seeded trace at the whole fleet, requests assigned "
        "round-robin, with per-replica attribution in the summary. "
        "Point --url at a serve/router.py front door instead to let the "
        "router pick replicas — its extras.router attribution lands in "
        "the same summary shape",
    )
    ap.add_argument("--model", default="qwen2:1.5b")
    ap.add_argument("-n", type=int, default=16, help="number of requests")
    ap.add_argument(
        "--mean-interarrival-ms", type=float, default=50.0,
        help="mean of the exponential inter-arrival distribution",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--budgets", default=",".join(map(str, DEFAULT_BUDGETS)),
        help="comma-separated max_new_tokens rotation",
    )
    ap.add_argument(
        "--prompt-len-dist", choices=["fixed", "lognormal"], default="fixed",
        help="prompt lengths: fixed rotation (default) or seeded "
        "heavy-tailed lognormal synthetic prompts",
    )
    ap.add_argument(
        "--prompt-len-median", type=float, default=48.0,
        help="lognormal: median prompt length in tokens",
    )
    ap.add_argument(
        "--prompt-len-sigma", type=float, default=1.0,
        help="lognormal: shape (bigger = heavier tail)",
    )
    ap.add_argument(
        "--prompt-len-max", type=int, default=1024,
        help="lognormal: clamp for drawn lengths",
    )
    ap.add_argument(
        "--shared-prefix-frac", type=float, default=0.0,
        help="fraction of requests carrying a shared system-prompt "
        "prefix (seeded; models the many-clients-one-server workload "
        "shared-prefix CoW paging targets)",
    )
    ap.add_argument(
        "--prefix-pool", type=int, default=1,
        help="number of DISTINCT shared prefixes to draw from",
    )
    ap.add_argument(
        "--shared-prefix-tokens", type=int, default=192,
        help="token length of each shared prefix",
    )
    ap.add_argument(
        "--tier-mix", default=None,
        help="seeded SLO-tier mix, e.g. 'high=0.2,low=0.8' (names from "
        "serve/protocol.PRIORITY_TIERS or bare integers; uncovered "
        "fraction mass draws 'normal'); the summary gains a per-tier "
        "percentile breakdown",
    )
    ap.add_argument(
        "--model-mix", default=None,
        help="seeded per-request model assignment, e.g. "
        "'small:1b=0.7,big:7b=0.3' (the last '=' separates "
        "name from fraction — model names may contain colons; "
        "uncovered fraction mass draws --model, which may be 'auto' "
        "for policy-routed traffic); independent of the arrival/"
        "length/tier streams, and the summary gains a per-model "
        "percentile breakdown + escalation counts",
    )
    ap.add_argument(
        "--temperature-dist", default=None,
        help="seeded per-request temperature assignment, e.g. "
        "'0.7=0.6,1.0=0.2' (each entry is temp=fraction, "
        "uncovered fraction mass draws 0.0 — greedy); independent of "
        "the arrival/length/tier/model streams, so the same trace "
        "replays across spec-on/spec-off arms, and the summary gains "
        "a sampled/greedy split",
    )
    ap.add_argument(
        "--tenant-mix", default=None,
        help="seeded per-request tenant assignment, e.g. 'a=0.7,b=0.3' "
        "(each entry is tenant=fraction, uncovered fraction "
        "mass draws 'default'); independent of every other stream, so "
        "the same trace replays with tenancy on or off. The summary "
        "gains a per-tenant percentile + Joules breakdown, and when "
        "the target exposes GET /debug/tenants the server's table is "
        "attached next to it (tenants_server) as the cross-check "
        "against these client-side by-hand sums",
    )
    ap.add_argument(
        "--fake", action="store_true",
        help="drive an in-process fake-backend continuous scheduler "
        "instead of a live server (hermetic demo/CI)",
    )
    ap.add_argument(
        "--fake-joules-per-token", type=float, default=0.0,
        help="--fake: price the fake backend's decode tokens at this "
        "many modelled Joules each, so the per-tenant Joules breakdown "
        "and the /debug/tenants cross-check carry nonzero figures in "
        "the hermetic demo",
    )
    ap.add_argument(
        "--sessions", type=int, default=1,
        help="split the trace into N contiguous segments, each driven "
        "through a FRESH scheduler over the same backend (scheduler "
        "restart between segments — the prefix store must "
        "carry hits across them); --fake only",
    )
    ap.add_argument(
        "--prefix-share", action="store_true",
        help="--fake: enable the fake backend's cross-session prefix "
        "store; the summary gains a prefix_store hit/spill breakdown",
    )
    ap.add_argument(
        "--prefix-store-hbm-bytes", type=int, default=None,
        help="--fake: the fake store's device-byte budget (small values "
        "force spills so the breakdown shows restore traffic)",
    )
    ap.add_argument(
        "--cancel-frac", type=float, default=0.0,
        help="fraction of requests that stream and hang up mid-flight "
        "(seeded; exercises disconnect-driven retirement)",
    )
    ap.add_argument(
        "--cancel-after-tokens-dist", default="4,32",
        help="inclusive uniform range 'lo,hi' of delivered tokens after "
        "which a cancelling client hangs up",
    )
    ap.add_argument(
        "--deadline-ms", type=float, default=None,
        help="per-request deadline stamped on every request "
        "(x_deadline_ms; scheduler-enforced pre-admission + mid-flight)",
    )
    ap.add_argument(
        "--slo", default=None,
        help="SLO objectives in the serve --slo grammar, e.g. "
        "'ttft_p99_ms<=250,completion_p95_s<=4': the summary "
        "gains per-objective EXACT attainment computed client-side from "
        "the raw records (plus per-tier/per-model splits when a mix is "
        "active) — the cross-check for the server's bucket-interpolated "
        "/debug/timeseries estimate",
    )
    args = ap.parse_args()
    slo_objectives = None
    if args.slo:
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.slo import (
            parse_slo_spec,
        )

        try:
            slo_objectives = parse_slo_spec(args.slo)
        except ValueError as exc:
            ap.error(str(exc))
    budgets = [int(b) for b in args.budgets.split(",") if b]
    workload = build_workload(
        args.n,
        args.mean_interarrival_ms / 1e3,
        seed=args.seed,
        model=args.model,
        budgets=budgets,
        prompt_len_dist=(
            None if args.prompt_len_dist == "fixed" else args.prompt_len_dist
        ),
        prompt_len_median=args.prompt_len_median,
        prompt_len_sigma=args.prompt_len_sigma,
        prompt_len_max=args.prompt_len_max,
        deadline_ms=args.deadline_ms,
        shared_prefix_frac=args.shared_prefix_frac,
        prefix_pool=args.prefix_pool,
        shared_prefix_tokens=args.shared_prefix_tokens,
        tier_mix=parse_tier_mix(args.tier_mix) if args.tier_mix else None,
        model_mix=(
            parse_model_mix(args.model_mix) if args.model_mix else None
        ),
        temperature_dist=(
            parse_temperature_dist(args.temperature_dist)
            if args.temperature_dist
            else None
        ),
        tenant_mix=(
            parse_tenant_mix(args.tenant_mix) if args.tenant_mix else None
        ),
    )
    cancellations = None
    if args.cancel_frac > 0:
        lo, _, hi = args.cancel_after_tokens_dist.partition(",")
        cancellations = build_cancellations(
            args.n,
            args.cancel_frac,
            after_tokens=(int(lo), int(hi or lo)),
            seed=args.seed,
        )
    prefix_counters0 = None
    if args.fake:
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import (
            FakeBackend,
        )
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.scheduler import (
            ContinuousScheduler,
        )

        backend = FakeBackend(
            tokens_per_s=500.0,
            simulate_delay=True,
            joules_per_token=args.fake_joules_per_token,
            prefix_share=args.prefix_share,
            prefix_store_hbm_bytes=args.prefix_store_hbm_bytes,
        )
        if args.prefix_share:
            prefix_counters0 = prefix_store_counters()
        records = []

        def _build_sched():
            # mixed-model traffic drives the multi-model fleet: one
            # continuous lane per model, so the fake demo
            # exercises the same concurrency the real fleet serves
            if args.model_mix:
                from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.model_fleet import (  # noqa: E501
                    ModelFleetScheduler,
                )

                return ModelFleetScheduler(
                    backend,
                    models=sorted(parse_model_mix(args.model_mix)),
                )
            return ContinuousScheduler(backend)

        # one scheduler per session segment over the SAME backend: a
        # restart mid-trace is exactly what the engine store survives
        for segment in session_segments(workload, max(1, args.sessions)):
            if not segment:
                continue
            sched = _build_sched()
            sched.start()
            try:
                seg_cancellations = cancellations
                if cancellations is not None and args.sessions > 1:
                    seg_cancellations = None  # plans index the full trace
                records.extend(
                    run_load(
                        sched.submit,
                        segment,
                        stream_submit=lambda req: channel_chunks(
                            sched.submit_stream(req)
                        ),
                        cancellations=seg_cancellations,
                    )
                )
            finally:
                sched.stop()
        target = (
            f"fake-continuous×{args.sessions}"
            if args.sessions > 1
            else "fake-continuous"
        )
    elif args.targets:
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import (
            RemoteHTTPBackend,
        )

        names = [t for t in args.targets.split(",") if t]
        clients = {
            name: RemoteHTTPBackend(
                name if name.startswith("http") else f"http://{name}"
            )
            for name in names
        }
        counter = itertools.count()
        lock = threading.Lock()

        def _pick_target():
            with lock:
                return names[next(counter) % len(names)]

        def _stamp_target(result, name):
            router = dict((result.extras or {}).get("router") or {})
            router.setdefault("replica", name)
            result.extras = {**(result.extras or {}), "router": router}
            return result

        def fleet_submit(request):
            name = _pick_target()
            return _stamp_target(clients[name].generate(request), name)

        def fleet_stream(request):
            name = _pick_target()
            chunks = clients[name].generate_stream(request)
            try:
                for chunk in chunks:
                    if (
                        getattr(chunk, "done", False)
                        and chunk.result is not None
                    ):
                        _stamp_target(chunk.result, name)
                    yield chunk
            finally:
                # closing this generator (the cancellation plan's
                # disconnect) must close the wire stream NOW, not at GC
                chunks.close()

        records = run_load(
            fleet_submit,
            workload,
            stream_submit=fleet_stream,
            cancellations=cancellations,
        )
        target = args.targets
    elif args.url:
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import (
            RemoteHTTPBackend,
        )

        client = RemoteHTTPBackend(args.url)
        records = run_load(
            client.generate,
            workload,
            stream_submit=client.generate_stream,
            cancellations=cancellations,
        )
        target = args.url
    else:
        ap.error("one of --url, --targets or --fake is required")
        return 2
    summary = summarize(records, slo=slo_objectives)
    if args.tenant_mix:
        server_view = _tenants_server_view(args)
        if server_view is not None:
            # the SERVER's tenant table next to the client-side by-hand
            # sums (summary["tenants"]): the cross-check — the
            # two must agree on requests/tokens, and joules must match
            # the per-tenant sums within rounding
            summary["tenants_server"] = server_view
    if prefix_counters0 is not None:
        after = prefix_store_counters()
        summary["prefix_store"] = {
            key: round(after[key] - prefix_counters0[key], 2)
            for key in after
        }
        if args.sessions > 1:
            summary["prefix_store"]["sessions"] = args.sessions
    print(json.dumps({"load": "poisson", "target": target, **summary}))
    return 0 if summary["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
