"""Persistent cross-session prefix store: a radix tree over refcounted
pages with host-RAM spill.

Counterpart of the JAX package's ``engine/radix_store.py`` on torch
tensors: the seed slabs and spilled blobs are CPU tensors in the
cache's dtype (numpy has no bfloat16), byte counts are ``numel ×
element_size``, and a page rebuild writes the pool in place through
``paged_kv``'s ``_paginate`` / ``quantize_chunks`` / ``scatter_pages``.
This module promotes prefix reuse to an ENGINE-level, session-independent
store in the RadixAttention/SGLang shape:

- :class:`RadixPrefixStore` is owned by the engine (``TorchEngine
  (prefix_share=True)`` builds one) and OUTLIVES every stepped session —
  a joiner in a fresh session (prior session closed, scheduler
  restarted) still hits prefixes published before;
- the index is a token-id RADIX TREE: each :class:`RadixNode` covers one
  token segment ``[start, end)`` of a published prefix, with node
  SPLITTING on partial-edge divergence — two prompts sharing 150 tokens
  then diverging share one 150-token node instead of two flat entries;
- a node owns the pool pages FULLY covered by its segment (prompt-order
  page indices ``[start // page, end // page)``) at one refcount each
  (``PagePool.share``), plus the segment's PRE-quantization bf16 seed
  slab held in HOST memory — publication is PAGE-BACKED for divergent
  tails too (no page cap), so a second-generation sharer maps the first
  sharer's tail pages read-only;
- cold nodes SPILL to host RAM: their pages leave the pool through the
  ``PagePool.swap_out`` blob (store-held pages are unshared at
  spill time, so the shared-page swap refusal does not apply) and come
  back through ``swap_in`` into FRESH pages on the next hit — int8
  pools round-trip codes + per-position scales bit-exactly. A node
  whose blob is gone rebuilds its pages from the seed slab (the same
  paginate→quantize path that wrote them originally, so the rebuilt
  pages are bit-identical);
- capacity is governed by an explicit byte-budget split with the
  weight-LRU envelope: ``hbm_bytes`` caps the store's device-resident
  page bytes (over-budget spills LRU-cold nodes), ``host_bytes`` caps
  blob + seed bytes (over-budget evicts LRU-cold leaves). Both knobs
  ride ``serve --prefix-store-hbm-bytes / --prefix-store-host-bytes``.

Pool lifecycle: a stepped session ATTACHES its pool at open
(:meth:`attach_pool`) and DETACHES at close (:meth:`detach_pool`) —
detach spills every device-resident node of that pool to host (rows are
already freed at close, so the store is the sole holder and the swap
succeeds), which is what makes the store's content survive the pool it
was published from. ``scope="session"`` instead drops the model's whole
tree at detach — the session-scoped lifetime, kept as a baseline.

Threading: the store mutates only under
the scheduler's backend lock (session admission / close). Reads from
the debug endpoints race that by design and are guarded by the callers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..obs.flight import (
    EV_PREFIX_EVICT,
    EV_PREFIX_RESTORE,
    EV_PREFIX_SPILL,
    FLIGHT,
)
from ..obs.metrics import REGISTRY, enabled as _obs_enabled
from .prefix import PREFIX_EVICTIONS_C, common_prefix_len

# -- obs families ------------------------------------------------------------
STORE_NODES_G = REGISTRY.gauge(
    "llm_prefix_store_nodes",
    "Radix nodes currently held by the engine prefix store (all models)",
)
STORE_HBM_PAGES_G = REGISTRY.gauge(
    "llm_prefix_store_hbm_pages",
    "Pool pages the prefix store holds device-resident (its own "
    "refcount; live rows mapping them add theirs) — the figure the "
    "router's least-pages policy discounts from pool occupancy",
)
STORE_HOST_BYTES_G = REGISTRY.gauge(
    "llm_prefix_store_host_bytes",
    "Host bytes the prefix store holds: spilled page blobs + the "
    "pre-quantization seed slabs (always host-resident)",
)
STORE_HITS_C = REGISTRY.counter(
    "llm_prefix_store_hits_total",
    "Prefix-store hits consumed by a joining request (cross-session "
    "hits included; tokens on llm_prefix_hit_tokens_total)",
)
STORE_SPILLS_C = REGISTRY.counter(
    "llm_prefix_store_spills_total",
    "Cold prefix-store nodes whose pages were swapped out to host RAM "
    "(budget pressure or pool detach at session close)",
)
STORE_RESTORES_C = REGISTRY.counter(
    "llm_prefix_store_restores_total",
    "Spilled prefix-store nodes swapped back into fresh pool pages on "
    "a hit (blob swap-in, or bit-exact rebuild from the seed slab)",
)
STORE_EVICTIONS_C = REGISTRY.counter(
    "llm_prefix_store_evictions_total",
    "Prefix-store nodes evicted outright (LRU leaves under host-byte "
    "or node-capacity pressure); their page references return to the "
    "pool and their host bytes are released",
)


# -- prefix digest (affinity routing) ------------------------------------------
# Bounds on the /healthz-exported summary: entries are top-level radix
# prefixes (most-recent first), each hashing at most DIGEST_MAX_HASHES
# page-sized token chunks — the whole digest stays a few KB however
# large the store grows (the router probes it once per probe interval).
DIGEST_MAX_PREFIXES = 32
DIGEST_MAX_HASHES = 16


def prefix_chunk_hashes(
    ids, page: int, max_hashes: Optional[int] = None
) -> List[str]:
    """Stable page-chunk hashes of a token-id sequence — THE digest
    hash. The store's export and the router's probe-side estimator both
    call this, so a replica's published chunk and the router's hashed
    prompt chunk agree byte-for-byte (blake2b-64 over the ascii token
    ids; only FULL pages hash — match resolution is one page)."""
    import hashlib

    n = len(ids) // max(1, page)
    if max_hashes is not None:
        n = min(n, max_hashes)
    out: List[str] = []
    for i in range(n):
        chunk = ids[i * page : (i + 1) * page]
        out.append(
            hashlib.blake2b(
                ",".join(str(int(t)) for t in chunk).encode("ascii"),
                digest_size=8,
            ).hexdigest()
        )
    return out


def _host_slab(arr) -> torch.Tensor:
    """Device (or host) tensor, or a numpy array → an owned, contiguous
    CPU tensor in its own dtype."""
    return torch.as_tensor(arr).to("cpu", copy=True).contiguous()


def _nbytes(obj) -> int:
    if obj is None:
        return 0
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    return int(obj.numel() * obj.element_size())


def _blob_nbytes(blob) -> int:
    if blob is None:
        return 0
    return int(blob.nbytes)


def _cut_chunks(chunks, lo: int, hi: int):
    if isinstance(chunks, dict):
        return {k: v[lo:hi].clone() for k, v in chunks.items()}
    return chunks[lo:hi].clone()


def _split_blob(blob, k: int) -> Tuple[object, object]:
    """Split one PageSwapBlob at chunk ``k`` → (top, bottom)."""
    from .paged_kv import PageSwapBlob

    def make(lo, hi):
        kc = _cut_chunks(blob.k_chunks, lo, hi)
        vc = _cut_chunks(blob.v_chunks, lo, hi)
        return PageSwapBlob(
            k_chunks=kc,
            v_chunks=vc,
            n_pages=hi - lo,
            page_size=blob.page_size,
            quantized=blob.quantized,
            nbytes=_nbytes(kc) + _nbytes(vc),
        )

    return make(0, k), make(k, blob.n_pages)


class RadixNode:
    """One token segment ``[start, start + len(edge))`` of a published
    prefix. The node's PAGE SPAN is the prompt-order page-index range
    ``[start // page, end // page)`` — every full page belongs to
    exactly one node along a path (the partial boundary page at a
    divergence is never shared: the copy-on-write rule). Tiers:

    - ``hbm``: ``own_pages`` lists the pool page ids (one store
      refcount each) in the model's currently-attached pool;
    - ``host``: ``blob`` holds the swapped page payload;
    - ``seed``: neither — a contiguous-session publication, or a node
      whose pages were dropped; a paged hit rebuilds pages from the
      seed slab.

    ``seg_k``/``seg_v`` are the segment's host (pre-quantization)
    K/V ``[L, Hkv, len(edge), D]`` — always present; the full-path seed
    a tail prefill attends through is the concatenation of segments.
    """

    __slots__ = (
        "edge", "start", "parent", "children",
        "seg_k", "seg_v", "own_pages", "blob", "stamp",
    )

    def __init__(self, edge, start: int, parent: "Optional[RadixNode]"):
        self.edge: List[int] = list(edge)
        self.start = int(start)
        self.parent = parent
        self.children: Dict[int, RadixNode] = {}
        self.seg_k: Optional[torch.Tensor] = None
        self.seg_v: Optional[torch.Tensor] = None
        self.own_pages: Optional[List[int]] = None  # hbm tier
        self.blob = None  # host tier (PageSwapBlob)
        self.stamp = 0

    @property
    def end(self) -> int:
        return self.start + len(self.edge)

    @property
    def tier(self) -> str:
        if self.own_pages is not None:
            return "hbm"
        if self.blob is not None:
            return "host"
        return "seed"

    def page_span(self, page_size: int) -> int:
        """Full pages this segment owns (see the class docstring)."""
        if not page_size:
            return 0
        return self.end // page_size - self.start // page_size

    @property
    def seed_bytes(self) -> int:
        return _nbytes(self.seg_k) + _nbytes(self.seg_v)


@dataclasses.dataclass
class _ModelTree:
    root: RadixNode
    pool: Optional[object] = None  # attached PagePool (None: contiguous)
    page_size: int = 0
    page_nbytes: int = 0  # device bytes of ONE pool page (k+v, scales)


class RadixPrefixStore:
    """Engine-lifetime longest-match store (see the module docstring).

    ``capacity`` bounds the per-model node count (LRU leaf eviction) —
    the engine's ``prefix_index_entries`` knob, same default as the
    session index it replaced. ``hbm_bytes``/``host_bytes`` are the byte budgets
    (None = unbounded)."""

    def __init__(
        self,
        capacity: int = 16,
        hbm_bytes: Optional[int] = None,
        host_bytes: Optional[int] = None,
        scope: str = "engine",
    ) -> None:
        if scope not in ("engine", "session"):
            raise ValueError(
                f"prefix store scope must be 'engine' or 'session', "
                f"got {scope!r}"
            )
        self.capacity = max(1, int(capacity))
        self.hbm_bytes = hbm_bytes if hbm_bytes is None else int(hbm_bytes)
        self.host_bytes = (
            host_bytes if host_bytes is None else int(host_bytes)
        )
        self.scope = scope
        self._trees: Dict[str, _ModelTree] = {}
        self._clock = 0
        # accounting (gauge-published after every mutation)
        self._hbm_pages = 0
        self._hbm_bytes_used = 0
        self._host_bytes_used = 0

    # -- introspection ---------------------------------------------------------
    def _nodes_of(self, model: str) -> List[RadixNode]:
        tree = self._trees.get(model)
        if tree is None:
            return []
        out: List[RadixNode] = []
        stack = list(tree.root.children.values())
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(node.children.values())
        return out

    def __len__(self) -> int:
        return sum(len(self._nodes_of(m)) for m in self._trees)

    @property
    def hbm_pages_held(self) -> int:
        return self._hbm_pages

    @property
    def host_bytes_held(self) -> int:
        return self._host_bytes_used

    def debug_state(self) -> dict:
        """JSON-able snapshot for ``/debug/state``'s ``prefix_store``
        block: node count, tree depth, bytes by tier."""
        per_model = {}
        depth = 0
        tiers = {"hbm": 0, "host": 0, "seed": 0}
        for model in self._trees:
            nodes = self._nodes_of(model)
            if nodes:
                depth = max(depth, max(n.end for n in nodes))
            for n in nodes:
                tiers[n.tier] += 1
            per_model[model] = {
                "nodes": len(nodes),
                "tokens_indexed": sum(len(n.edge) for n in nodes),
                "attached_pool": self._trees[model].pool is not None,
            }
        return {
            "scope": self.scope,
            "nodes": sum(m["nodes"] for m in per_model.values()),
            "depth": depth,
            "capacity": self.capacity,
            "tiers": tiers,
            "hbm_pages": self._hbm_pages,
            "hbm_bytes": self._hbm_bytes_used,
            "hbm_budget_bytes": self.hbm_bytes,
            "host_bytes": self._host_bytes_used,
            "host_budget_bytes": self.host_bytes,
            "models": per_model,
        }

    def digest(
        self,
        max_prefixes: int = DIGEST_MAX_PREFIXES,
        max_hashes: int = DIGEST_MAX_HASHES,
    ) -> dict:
        """Bounded JSON-able summary of the store's top-level prefixes
        (affinity routing): one entry per root child — page-
        chunk hashes of the child's most-recently-used SPINE plus the
        spine's token depth — most-recent entries first, capped at
        ``max_prefixes`` entries × ``max_hashes`` hashes. Exported on
        ``/healthz`` and federated by ``Replica.probe`` so the router
        can estimate the longest prefix match a candidate replica holds
        WITHOUT shipping prompts or token ids around the fleet."""
        entries: List[dict] = []
        for model, tree in self._trees.items():
            page = tree.page_size or 64
            for child in tree.root.children.values():
                # subtree recency for the LRU-most-recent entry cap
                stamp = child.stamp
                stack = list(child.children.values())
                while stack:
                    n = stack.pop()
                    stamp = max(stamp, n.stamp)
                    stack.extend(n.children.values())
                # the spine: at each branch follow the freshest child —
                # the path a repeat of the hottest prompt would walk
                ids: List[int] = []
                node: Optional[RadixNode] = child
                while node is not None:
                    ids.extend(node.edge)
                    node = (
                        max(
                            node.children.values(), key=lambda c: c.stamp
                        )
                        if node.children
                        else None
                    )
                entries.append(
                    {
                        "model": model,
                        "page": int(page),
                        "h": prefix_chunk_hashes(ids, page, max_hashes),
                        "tokens": len(ids),
                        "stamp": int(stamp),
                    }
                )
        entries.sort(key=lambda e: (-e["stamp"], e["model"]))
        entries = entries[: max(0, int(max_prefixes))]
        for e in entries:
            del e["stamp"]
        return {"v": 1, "entries": entries}

    def _publish_gauges(self) -> None:
        if not _obs_enabled():
            return
        STORE_NODES_G.set(len(self))
        STORE_HBM_PAGES_G.set(self._hbm_pages)
        STORE_HOST_BYTES_G.set(self._host_bytes_used)

    # -- pool lifecycle --------------------------------------------------------
    def attach_pool(self, model: str, pool) -> None:
        """Register ``model``'s live pool (stepped-session open). A
        different pool already attached (concurrent session) is
        detached first — its device-resident nodes spill to host. The
        store's HBM tier always refers to the ATTACHED pool."""
        tree = self._trees.get(model)
        if tree is None:
            tree = _ModelTree(root=RadixNode([], 0, None))
            self._trees[model] = tree
        if tree.pool is pool:
            return
        if tree.pool is not None:
            self.detach_pool(model, tree.pool)
        tree.pool = pool
        if pool is not None:
            tree.page_size = pool.page_size
            tree.page_nbytes = (
                pool.payload_nbytes() // max(1, pool.n_pages)
            )

    def detach_pool(self, model: str, pool) -> None:
        """The session-close half: every HBM node of ``pool`` leaves the
        device — spilled to a host blob when the store is the sole
        holder (rows are freed before close detaches, so this is the
        normal path), demoted to seed tier otherwise (its reference is
        dropped; readers keep theirs). ``scope="session"`` drops the
        model's whole tree instead — the session-scoped baseline."""
        tree = self._trees.get(model)
        if tree is None or (tree.pool is not None and tree.pool is not pool):
            return
        if self.scope == "session":
            for node in self._nodes_of(model):
                self._release_node(node, tree, evict=False)
            tree.root.children.clear()
            tree.pool = None
            self._publish_gauges()
            return
        if pool is not None:
            for node in self._nodes_of(model):
                if node.own_pages is None:
                    continue
                if not self._spill_node(node, tree):
                    self._drop_pages(node, tree)
        tree.pool = None
        self._enforce_host_budget()
        self._publish_gauges()

    def release_all(self) -> None:
        """Drop everything (tests/bench teardown): page references
        return to their attached pools, host bytes to zero."""
        for model, tree in list(self._trees.items()):
            for node in self._nodes_of(model):
                self._release_node(node, tree, evict=False)
        self._trees.clear()
        self._hbm_pages = 0
        self._hbm_bytes_used = 0
        self._host_bytes_used = 0
        self._publish_gauges()

    # -- lookup ----------------------------------------------------------------
    def match(
        self, model: str, ids: "List[int]"
    ) -> Tuple[List[Tuple[RadixNode, int]], int]:
        """Longest-match walk: ``([(node, tokens_matched_in_node)...],
        total_common)``. Side-effect free."""
        tree = self._trees.get(model)
        if tree is None:
            return [], 0
        path: List[Tuple[RadixNode, int]] = []
        node = tree.root
        common = 0
        while common < len(ids):
            child = node.children.get(ids[common])
            if child is None:
                break
            take = common_prefix_len(child.edge, ids[common:])
            if take == 0:
                break
            path.append((child, take))
            common += take
            if take < len(child.edge):
                break
            node = child
        return path, common

    def match_len(self, model: str, ids: "List[int]") -> int:
        return self.match(model, ids)[1]

    def touch(self, model: str, ids: "List[int]") -> None:
        path, _ = self.match(model, ids)
        self._touch_path(path)

    def _touch_path(self, path) -> None:
        self._clock += 1
        for node, _take in path:
            node.stamp = self._clock

    def record_hit(self, model: str, ids: "List[int]") -> None:
        """Account one CONSUMED hit (join_begin committed to the plan):
        recency refresh + the store hit counter (token/page figures ride
        ``prefix.observe_hit`` as before)."""
        self.touch(model, ids)
        STORE_HITS_C.inc()

    def seed(
        self, model: str, ids: "List[int]", common: int
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The full-path host seed ``[L, Hkv, common, D]`` (K, V) for
        the first ``common`` matched positions — concatenated from the
        path's segment slabs."""
        path, matched = self.match(model, ids)
        if matched < common or common <= 0:
            return None
        ks, vs = [], []
        acc = 0
        for node, take in path:
            if acc >= common:
                break
            use = min(take, common - acc)
            ks.append(node.seg_k[:, :, :use])
            vs.append(node.seg_v[:, :, :use])
            acc += use
        if acc < common:
            return None
        k = ks[0] if len(ks) == 1 else torch.cat(ks, dim=2)
        v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=2)
        return k[:, :, :common], v[:, :, :common]

    # -- page plans ------------------------------------------------------------
    def page_plan(self, model: str, ids: "List[int]", common: int) -> dict:
        """How a paged joiner could map the store's pages for its first
        ``common`` matched tokens — side-effect free (``can_join``
        probes it; ``restore``/``join_begin`` execute it):

        - ``hbm_lead``: page ids of the leading run that is ALREADY
          device-resident in the attached pool;
        - ``restore_nodes``: nodes (in path order) that must swap in /
          rebuild before the full run is mappable;
        - ``restore_pages``: fresh pool pages a full restore allocates;
        - ``full_pages``: the run length after a full restore
          (== ``common // page_size`` when the path is page-complete).
        """
        tree = self._trees.get(model)
        plan = {
            "hbm_lead": [],
            "restore_nodes": [],
            "restore_pages": 0,
            "full_pages": 0,
        }
        if tree is None or tree.pool is None or not tree.page_size:
            return plan
        target = common // tree.page_size
        if target <= 0:
            return plan
        path, matched = self.match(model, ids)
        acc = 0
        lead_open = True
        for node, take in path:
            if acc >= target:
                break
            usable = (
                (node.start + take) // tree.page_size
                - node.start // tree.page_size
            )
            usable = min(usable, target - acc)
            if usable <= 0:
                continue
            if node.tier == "hbm":
                if lead_open:
                    plan["hbm_lead"].extend(node.own_pages[:usable])
            else:
                lead_open = False
                plan["restore_nodes"].append(node)
                plan["restore_pages"] += node.page_span(tree.page_size)
            acc += usable
        plan["full_pages"] = acc
        return plan

    def hbm_run(self, model: str, ids: "List[int]") -> List[int]:
        """The leading device-resident page run for ``ids``' match —
        what a preemption resume compares its released shared pages
        against (ids drifted = the store moved on; degrade to
        recompute)."""
        tree = self._trees.get(model)
        if tree is None or not tree.page_size:
            return []
        common = self.match_len(model, ids)
        return self.page_plan(model, ids, common)["hbm_lead"]

    def restore(self, model: str, ids: "List[int]", common: int) -> bool:
        """Execute a plan's restores: each non-HBM node on the path (up
        to ``common``) swaps its blob into freshly allocated pool pages
        (or rebuilds them from the seed slab — bit-identical either
        way) and returns to the HBM tier. Writes ``pool.k/v`` in place
        (the session's carry holds the same tensors). Returns False when an
        allocation failed mid-way (the nodes already restored stay
        restored; callers degrade to the leading run)."""
        tree = self._trees.get(model)
        if tree is None or tree.pool is None:
            return False
        plan = self.page_plan(model, ids, common)
        ok = True
        for node in plan["restore_nodes"]:
            if not self._restore_node(node, tree, model, ids):
                ok = False
                break
        self._enforce_budgets(model)
        self._publish_gauges()
        return ok

    def _restore_node(
        self, node: RadixNode, tree: _ModelTree, model: str, ids
    ) -> bool:
        pool = tree.pool
        span = node.page_span(tree.page_size)
        if span == 0:
            return True
        pages = pool.try_alloc(span)
        if pages is None:
            return False
        had_blob = node.blob is not None
        if had_blob:
            pool.swap_in(node.blob, pages=pages)
            self._host_bytes_used -= _blob_nbytes(node.blob)
            node.blob = None
        else:
            self._rebuild_pages(node, tree, pages, model, ids)
        node.own_pages = list(pages)
        self._hbm_pages += span
        self._hbm_bytes_used += span * tree.page_nbytes
        STORE_RESTORES_C.inc()
        if _obs_enabled():
            FLIGHT.emit(
                EV_PREFIX_RESTORE,
                model=model,
                pages=span,
                tokens=len(node.edge),
                rebuilt=not had_blob,
            )
        return True

    def _rebuild_pages(
        self, node: RadixNode, tree: _ModelTree, pages, model: str, ids
    ) -> None:
        """Bit-exact page rebuild from the seed slabs: the pages cover
        token positions ``[first_page * ps, last_page * ps)`` which may
        start BEFORE ``node.start`` (the boundary page carries the tail
        of the parent's segment), so the slab is assembled from the
        NODE's own path up to ``node.end`` — not the querying prompt,
        which may diverge from the node's edge before its end."""
        from .paged_kv import _codes, _paginate, quantize_chunks, scatter_pages

        ps = tree.page_size
        node_ids: List[int] = []
        cur = node
        while cur is not None:
            node_ids[:0] = cur.edge
            cur = cur.parent
        seed = self.seed(model, node_ids, node.end)
        if seed is None:  # path raced an eviction — keep the node seed-tier
            raise RuntimeError("prefix-store seed vanished during rebuild")
        k_host, v_host = seed
        lo = (node.start // ps) * ps
        hi = (node.end // ps) * ps
        pool = tree.pool
        device = _codes(pool.k).device
        ck = _paginate(k_host[:, :, lo:hi].to(device), hi - lo, ps)
        cv = _paginate(v_host[:, :, lo:hi].to(device), hi - lo, ps)
        if pool.quantized:
            ck, cv = quantize_chunks(ck, cv)
        scatter_pages(pool.k, pool.v, pages, ck, cv)

    # -- publish ---------------------------------------------------------------
    def publish(
        self,
        model: str,
        ids,
        k_seed,
        v_seed,
        pages: "Optional[List[int]]" = None,
        pool=None,
    ) -> bool:
        """Index a completed prompt prefill. ``pages`` lists the
        publisher's pool pages for the prompt's FULL page-aligned
        chunks (prompt-order; the store takes one ``pool.share``
        reference per page it adopts) — None/[] for contiguous
        sessions. ``k_seed``/``v_seed`` are the prompt's
        pre-quantization K/V ``[L, Hkv, len(ids), D]`` (device or
        host). Publication is UNCAPPED: a joiner's divergent-tail pages
        are adopted too (the next sharer maps them
        read-only). Existing path nodes that lost their pages are
        PROMOTED back to HBM from the publisher's pages. Returns False
        when an existing path already covers ``ids`` (recency
        refreshes; promotion still happens)."""
        ids = list(ids)
        if len(ids) < 2:
            return False
        tree = self._trees.get(model)
        if tree is None:
            tree = _ModelTree(root=RadixNode([], 0, None))
            self._trees[model] = tree
        if pool is not None and tree.pool is None:
            self.attach_pool(model, pool)
        ps = tree.page_size
        full = len(ids) // ps if (ps and pool is not None and pages) else 0
        pages = list(pages or [])[:full]
        path, common = self.match(model, ids)
        # promotion: fully-traversed path nodes whose page span sits
        # inside the publisher's full-page run re-adopt device residency
        if pages and pool is tree.pool and pool is not None:
            for node, take in path:
                if take < len(node.edge):
                    break
                span = node.page_span(ps)
                if node.end // ps > len(pages):
                    break
                if node.own_pages is None and span:
                    own = pages[node.start // ps : node.end // ps]
                    pool.share(own)
                    node.own_pages = own
                    self._hbm_pages += span
                    self._hbm_bytes_used += span * tree.page_nbytes
                    if node.blob is not None:
                        self._host_bytes_used -= _blob_nbytes(node.blob)
                        node.blob = None
        if common >= len(ids):
            self._touch_path(path)
            self._enforce_budgets(model)
            self._publish_gauges()
            return False
        # split the last partially-matched node at the divergence
        attach = tree.root if not path else path[-1][0]
        if path and path[-1][1] < len(path[-1][0].edge):
            attach = self._split(path[-1][0], path[-1][1], tree)
        # host seed slab for the new leaf's segment (cut on the device
        # first: only the new positions cross to the host)
        leaf = RadixNode(ids[common:], common, attach)
        leaf.seg_k = _host_slab(torch.as_tensor(k_seed)[:, :, common : len(ids)])
        leaf.seg_v = _host_slab(torch.as_tensor(v_seed)[:, :, common : len(ids)])
        self._host_bytes_used += leaf.seed_bytes
        span = leaf.page_span(ps) if ps else 0
        if span and pages and pool is tree.pool and pool is not None:
            own = pages[common // ps : len(ids) // ps]
            pool.share(own)
            leaf.own_pages = own
            self._hbm_pages += span
            self._hbm_bytes_used += span * tree.page_nbytes
        attach.children[ids[common]] = leaf
        self._clock += 1
        leaf.stamp = self._clock
        self._touch_path(path)
        self._enforce_budgets(model)
        self._publish_gauges()
        return True

    def _split(self, node: RadixNode, k: int, tree: _ModelTree) -> RadixNode:
        """Split ``node`` ``k`` tokens into its edge → the new TOP node
        (``[start, start+k)``); ``node`` keeps the bottom. Page runs and
        the host blob split at the page boundary ``(start+k) // page``;
        the segment seeds split at the token boundary."""
        ps = tree.page_size
        top = RadixNode(node.edge[:k], node.start, node.parent)
        top.seg_k = node.seg_k[:, :, :k].contiguous()
        top.seg_v = node.seg_v[:, :, :k].contiguous()
        cut_tok = node.start + k
        p_cut = (cut_tok // ps - node.start // ps) if ps else 0
        if node.own_pages is not None:
            top.own_pages = node.own_pages[:p_cut]
            node.own_pages = node.own_pages[p_cut:]
        elif node.blob is not None:
            if p_cut == 0:
                pass  # the cut page-aligns into the bottom; top is seed-tier
            elif p_cut >= node.blob.n_pages:
                top.blob, node.blob = node.blob, None
            else:
                top.blob, node.blob = _split_blob(node.blob, p_cut)
        # seed bytes: the split copies re-own the same token count;
        # recompute exactly
        self._host_bytes_used -= _nbytes(node.seg_k) + _nbytes(node.seg_v)
        node.edge = node.edge[k:]
        node.start = cut_tok
        node.seg_k = node.seg_k[:, :, k:].contiguous()
        node.seg_v = node.seg_v[:, :, k:].contiguous()
        self._host_bytes_used += top.seed_bytes + node.seed_bytes
        top.stamp = node.stamp
        top.children = {node.edge[0]: node}
        if node.parent is not None:
            node.parent.children[top.edge[0]] = top
        node.parent = top
        return top

    # -- spill / evict ---------------------------------------------------------
    def _spill_node(self, node: RadixNode, tree: _ModelTree) -> bool:
        """Swap one HBM node's pages out to a host blob. Requires the
        store to be the pages' SOLE holder (refcount 1 — live readers
        keep spill off the table, which is exactly the shared-page swap
        refusal's contract). Returns False when ineligible."""
        pool = tree.pool
        if pool is None or node.own_pages is None:
            return False
        span = len(node.own_pages)
        if span == 0:
            node.own_pages = None
            return True
        if any(pool.refcount(p) != 1 for p in node.own_pages):
            return False
        node.blob = pool.swap_out(node.own_pages)
        node.own_pages = None
        self._hbm_pages -= span
        self._hbm_bytes_used -= span * tree.page_nbytes
        self._host_bytes_used += _blob_nbytes(node.blob)
        STORE_SPILLS_C.inc()
        if _obs_enabled():
            FLIGHT.emit(
                EV_PREFIX_SPILL,
                pages=span,
                tokens=len(node.edge),
                blob_bytes=_blob_nbytes(node.blob),
            )
        return True

    def _drop_pages(self, node: RadixNode, tree: _ModelTree) -> None:
        """Demote an HBM node to seed tier WITHOUT spilling: drop the
        store's page references (readers keep theirs). Used when a swap
        is refused (shared pages) at pool detach."""
        if node.own_pages is None:
            return
        span = len(node.own_pages)
        if span and tree.pool is not None:
            tree.pool.free(node.own_pages)
        node.own_pages = None
        self._hbm_pages -= span
        self._hbm_bytes_used -= span * tree.page_nbytes

    def _release_node(
        self, node: RadixNode, tree: _ModelTree, evict: bool = True
    ) -> None:
        """Release one node's holdings (pages back to the pool, host
        bytes down). Does NOT unlink it from the tree."""
        self._drop_pages(node, tree)
        if node.blob is not None:
            self._host_bytes_used -= _blob_nbytes(node.blob)
            node.blob = None
        self._host_bytes_used -= node.seed_bytes
        node.seg_k = node.seg_v = None
        if evict:
            STORE_EVICTIONS_C.inc()
            PREFIX_EVICTIONS_C.inc()
            if _obs_enabled():
                FLIGHT.emit(EV_PREFIX_EVICT, tokens=len(node.edge))

    def _evict_leaf(self, model: str) -> bool:
        """Evict the LRU LEAF of ``model`` (interior nodes carry
        descendants' prefix content and are never evicted first — the
        SGLang rule)."""
        tree = self._trees.get(model)
        if tree is None:
            return False
        leaves = [n for n in self._nodes_of(model) if not n.children]
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: n.stamp)
        self._release_node(victim, tree)
        parent = victim.parent
        if parent is not None:
            parent.children.pop(victim.edge[0], None)
        return True

    def _enforce_budgets(self, model: str) -> None:
        tree = self._trees.get(model)
        # node-count capacity (per model)
        while len(self._nodes_of(model)) > self.capacity:
            if not self._evict_leaf(model):
                break
        # HBM budget: spill LRU-cold device-resident nodes
        if self.hbm_bytes is not None and tree is not None:
            while self._hbm_bytes_used > self.hbm_bytes:
                hbm = [
                    n
                    for n in self._nodes_of(model)
                    if n.own_pages is not None and n.own_pages
                ]
                hbm.sort(key=lambda n: n.stamp)
                spilled = False
                for node in hbm:
                    if self._spill_node(node, tree):
                        spilled = True
                        break
                if not spilled:
                    break
        self._enforce_host_budget()

    def _enforce_host_budget(self) -> None:
        if self.host_bytes is None:
            return
        while self._host_bytes_used > self.host_bytes:
            victim_model = None
            victim_stamp = None
            for model in self._trees:
                leaves = [
                    n for n in self._nodes_of(model) if not n.children
                ]
                for n in leaves:
                    if victim_stamp is None or n.stamp < victim_stamp:
                        victim_model, victim_stamp = model, n.stamp
            if victim_model is None or not self._evict_leaf(victim_model):
                break
