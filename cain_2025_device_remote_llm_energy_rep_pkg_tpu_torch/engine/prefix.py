"""Shared-prefix reuse: the metric families and helpers shared by the
page pool, the stepped sessions and the engine-level prefix store.

Counterpart of the JAX package's ``engine/prefix.py``. The
``llm_prefix_*`` families and the hit / copy-on-write accounting below
are the stable surface; the store adds its own ``llm_prefix_store_*``
families in ``radix_store.py``.

Why a seed slab next to the pages: the divergent-tail prefill must
attend to the prefix K/V at the precision the solo path would have
produced. For int8 pools, reconstructing the cache dtype from codes
would perturb the tail's logits and break token parity; the slab keeps
the publisher's exact pre-quantization values (scales are per position,
so SHARED pages need no re-quantization: sharers read the publisher's
codes and scales directly during decode). For contiguous sessions (no
pool) the slab alone carries the win.
"""

from __future__ import annotations

from typing import List

from ..obs.flight import EV_PREFIX_HIT, FLIGHT, trace_of
from ..obs.metrics import REGISTRY, enabled as _obs_enabled
from ..obs.trace import TRACER

PREFIX_HIT_TOKENS_C = REGISTRY.counter(
    "llm_prefix_hit_tokens_total",
    "Prompt tokens a session joiner did NOT recompute because a shared "
    "prefix was reused (mapped pages + seeded boundary positions)",
)
PREFIX_COW_COPIES_C = REGISTRY.counter(
    "llm_prefix_cow_copies_total",
    "Copy-on-write materialisations of the partial page at a joiner's "
    "divergence boundary (seeded positions copied into an owned page "
    "so shared pages stay read-only)",
)
PREFIX_EVICTIONS_C = REGISTRY.counter(
    "llm_prefix_evictions_total",
    "Prefix entries/nodes evicted (LRU capacity or byte-budget "
    "pressure); their page references return to the pool",
)
PREFIX_SHARED_PAGES_G = REGISTRY.gauge(
    "llm_prefix_shared_pages",
    "Pages of the most recent page pool currently held by MORE than one "
    "reader (prefix-store reference + sharer rows)",
)


def common_prefix_len(a: "List[int]", b: "List[int]") -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def observe_hit(tokens: int, pages: int, cow: bool) -> None:
    """Account one join-time prefix hit: ``tokens`` seeded positions the
    joiner will not recompute, ``pages`` read-only pool pages mapped
    into its table row, ``cow`` whether the divergence boundary forced
    a partial-page copy."""
    PREFIX_HIT_TOKENS_C.inc(tokens)
    if cow:
        PREFIX_COW_COPIES_C.inc()
    if _obs_enabled():
        # the scheduler holds the joiner's request span around admission
        # (TRACER.attach), so the hit links to that ticket's story
        FLIGHT.emit(
            EV_PREFIX_HIT,
            trace=trace_of(TRACER.current()),
            tokens=tokens,
            shared_pages=pages,
            cow=cow,
        )
