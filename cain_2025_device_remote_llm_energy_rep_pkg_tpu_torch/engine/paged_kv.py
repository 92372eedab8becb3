"""Paged KV-cache pool: block-table indirection for mixed-length batches.

Counterpart of the JAX package's ``engine/paged_kv.py``:

- one pool of fixed-size pages per layer, ``k/v: [L, P, Hkv, page, D]``
  (or int8 ``{"q": codes, "s": f32 scales [L, P, Hkv, page]}``);
- a request owns ``ceil(len / page)`` page indices from a host-side
  refcounted free-list allocator (allocation is a scheduler decision, not
  a device op); pages may be shared, and swapped out to host memory and
  back;
- the paged kernels (``ops/cuda_paged_attention.py``) read K/V through
  the page table; nothing gathers the pages into a contiguous cache;
- :func:`write_token` and :func:`write_prefill` write through the table
  (the write-through mode, whose decode reads the pool with B6).

Unlike the JAX arrays, the pool tensors are updated in place: the writers
write into the tensors they are given and return them. The pool keeps the
model's native head dim (the JAX engine pads stacked pools to 128 lanes
for its TPU kernels; the CUDA kernels need no padding).

Not ported yet: ``dp_shards`` (row sharding over a multi-device mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..models.quantize import quantize_kv_vector
from ..obs.metrics import REGISTRY, enabled as _obs_enabled, observe_swap
from .prefix import PREFIX_SHARED_PAGES_G

DEFAULT_PAGE_SIZE = 128

PoolLeaf = Union[torch.Tensor, Dict[str, torch.Tensor]]

# Pool-state gauges: pools are per batch, so the gauges track the most
# recent pool's state, which is the live one while a decode window runs.
_POOL_PAGES = REGISTRY.gauge(
    "llm_paged_pool_pages", "Total pages in the most recent page pool"
)
_POOL_FREE = REGISTRY.gauge(
    "llm_paged_pool_free_pages", "Free pages in the most recent page pool"
)
_POOL_OCCUPANCY = REGISTRY.gauge(
    "llm_paged_pool_occupancy",
    "Allocated fraction of the most recent page pool (0..1)",
)
_POOL_FRAGMENTATION = REGISTRY.gauge(
    "llm_paged_pool_fragmentation",
    "1 - (largest contiguous free run / free pages); 0 when free space "
    "is one run or the pool is full",
)
_POOL_EXHAUSTED = REGISTRY.counter(
    "llm_paged_pool_exhausted_total",
    "Allocations refused because the pool had too few free pages",
)


def _fragmentation(free: List[int]) -> float:
    """1 - (largest contiguous free run / free pages); 0 when free space
    is one run or the pool is full. One definition for the gauges and
    :meth:`PagePool.debug_state`."""
    if not free:
        return 0.0
    ordered = sorted(free)
    longest = run = 1
    for a, b in zip(ordered, ordered[1:]):
        run = run + 1 if b == a + 1 else 1
        longest = max(longest, run)
    return 1.0 - longest / len(free)


def _publish_pool_gauges(free: List[int], total: int, shared: int = 0) -> None:
    if not _obs_enabled():
        return
    _POOL_PAGES.set(total)
    _POOL_FREE.set(len(free))
    _POOL_OCCUPANCY.set(1.0 - len(free) / total if total else 0.0)
    _POOL_FRAGMENTATION.set(_fragmentation(free))
    PREFIX_SHARED_PAGES_G.set(shared)


def _codes(leaf: PoolLeaf) -> torch.Tensor:
    """The tensor that carries a pool leaf's layout: the int8 codes of a
    quantized ``{"q","s"}`` leaf, the tensor itself otherwise."""
    return leaf["q"] if isinstance(leaf, dict) else leaf


def _nbytes(leaf: PoolLeaf) -> int:
    parts = leaf.values() if isinstance(leaf, dict) else (leaf,)
    return sum(t.numel() * t.element_size() for t in parts)


class PagePoolExhausted(RuntimeError):
    """No free pages left: the scheduler must evict or defer admission."""


@dataclasses.dataclass
class PageSwapBlob:
    """Host-resident payload of swapped-out pages: page chunks in
    :func:`scatter_pages` layout, ``[N, L, Hkv, page, D]`` (``{"q","s"}``
    for int8 pools), so :meth:`PagePool.swap_in` is one allocation plus
    one scatter. The chunks are CPU tensors where the JAX package keeps
    numpy arrays (numpy has no bfloat16). ``nbytes`` is the host
    footprint the swap counter accounts."""

    k_chunks: PoolLeaf
    v_chunks: PoolLeaf
    n_pages: int
    page_size: int
    quantized: bool
    nbytes: int


@dataclasses.dataclass
class PagePool:
    """Device pool + host-side free-list allocator.

    Allocation is refcounted: ``alloc`` hands out pages from the head of
    the free list at one reference, :meth:`share` adds a reader, and
    :meth:`free` drops one reference and returns a page to the tail of
    the list when its last reader lets go. ``quantized`` pools hold int8
    codes with one f32 scale per (layer, page, head, position) vector,
    the scheme of the contiguous int8 cache."""

    k: PoolLeaf  # [L, P, Hkv, page, D], or {"q","s"}
    v: PoolLeaf
    page_size: int
    _free: List[int] = dataclasses.field(default_factory=list)
    # page index -> live reference count; absent = on the free list
    _refs: Dict[int, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(
        cls,
        n_layers: int,
        n_pages: int,
        n_kv_heads: int,
        d_head: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        dtype: torch.dtype = torch.bfloat16,
        quantized: bool = False,
        device="cpu",
    ) -> "PagePool":
        shape = (n_layers, n_pages, n_kv_heads, page_size, d_head)

        def leaf() -> PoolLeaf:
            if quantized:
                return {
                    "q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                }
            return torch.zeros(shape, dtype=dtype, device=device)

        pool = cls(k=leaf(), v=leaf(), page_size=page_size, _free=list(range(n_pages)))
        _publish_pool_gauges(pool._free, n_pages)
        return pool

    @property
    def quantized(self) -> bool:
        return isinstance(self.k, dict)

    @property
    def n_pages(self) -> int:
        return _codes(self.k).shape[1]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages held by more than one reader."""
        return sum(1 for c in self._refs.values() if c >= 2)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def payload_nbytes(self) -> int:
        """Bytes of the pool's K+V payload (int8 pools count codes and
        scales)."""
        return _nbytes(self.k) + _nbytes(self.v)

    def debug_state(self) -> dict:
        """JSON-able pool snapshot (the gauges' definitions)."""
        total = self.n_pages
        return {
            "pages": total,
            "free_pages": len(self._free),
            "page_size": self.page_size,
            "quantized": self.quantized,
            "occupancy": round(1.0 - len(self._free) / total if total else 0.0, 4),
            "fragmentation": round(_fragmentation(self._free), 4),
            "shared_pages": self.shared_pages,
            "payload_bytes": self.payload_nbytes(),
        }

    def alloc(self, n_pages: int) -> List[int]:
        if n_pages > len(self._free):
            _POOL_EXHAUSTED.inc()
            raise PagePoolExhausted(
                f"need {n_pages} pages, {len(self._free)} free of "
                f"{self.n_pages} — evict a finished request or grow the pool"
            )
        pages, self._free = self._free[:n_pages], self._free[n_pages:]
        for p in pages:
            self._refs[p] = 1
        _publish_pool_gauges(self._free, self.n_pages, self.shared_pages)
        return pages

    def try_alloc(self, n_pages: int) -> Optional[List[int]]:
        """``alloc`` that returns None instead of raising when the pool is
        short (the admission probe)."""
        if n_pages > len(self._free):
            return None
        return self.alloc(n_pages)

    def share(self, pages: List[int]) -> None:
        """Add one reader to each page: it recycles only after every
        holder called :meth:`free` once. Sharing a free page raises."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not allocated — cannot share a free page")
            self._refs[p] += 1
        _publish_pool_gauges(self._free, self.n_pages, self.shared_pages)

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; a page whose last reader left
        returns to the free list. Freeing a free page raises."""
        for p in pages:
            refs = self._refs.get(p)
            if refs is None:
                raise ValueError(f"page {p} is already free (double free)")
            if refs > 1:
                self._refs[p] = refs - 1
            else:
                del self._refs[p]
                self._free.append(p)
        _publish_pool_gauges(self._free, self.n_pages, self.shared_pages)

    def swap_out(self, pages: List[int]) -> PageSwapBlob:
        """Copy ``pages``' payload to host memory and free them. Only
        pages this reader holds alone may be swapped: a shared page has
        other readers whose content must stay on the device, so passing
        one (or a free page) raises before anything moves."""
        for p in pages:
            refs = self._refs.get(p)
            if refs is None:
                raise ValueError(f"page {p} is free — cannot swap it out")
            if refs > 1:
                raise ValueError(
                    f"page {p} is shared (refcount {refs}) — shared CoW "
                    "prefix pages are released, never swapped"
                )
        blob = self.copy_out(pages)
        self.free(pages)
        observe_swap("out", blob.nbytes)
        return blob

    def copy_out(self, pages: List[int]) -> PageSwapBlob:
        """Copy ``pages``' payload to host memory as a swap blob, leaving
        the pages and their references as they are (a shared page keeps
        its other readers)."""
        idx = torch.as_tensor(pages, dtype=torch.int64, device=_codes(self.k).device)

        def gather(pool):  # [L, N, ...] -> scatter_pages' [N, L, ...] chunks
            if isinstance(pool, dict):
                return {k: t[:, idx].transpose(0, 1).cpu() for k, t in pool.items()}
            return pool[:, idx].transpose(0, 1).cpu()

        k_chunks, v_chunks = gather(self.k), gather(self.v)
        return PageSwapBlob(
            k_chunks=k_chunks, v_chunks=v_chunks, n_pages=len(pages),
            page_size=self.page_size, quantized=self.quantized,
            nbytes=_nbytes(k_chunks) + _nbytes(v_chunks),
        )

    def swap_in(self, blob: PageSwapBlob, pages: Optional[List[int]] = None) -> List[int]:
        """Write a swapped blob back into the pool, bit for bit (int8 blobs
        carry codes and scales, so nothing is quantized again): into
        ``blob.n_pages`` freshly allocated pages, or into ``pages`` the
        caller reserved. Returns the pages in blob chunk order."""
        if blob.quantized != self.quantized or blob.page_size != self.page_size:
            raise ValueError(
                "swap blob does not match this pool's layout "
                f"(page_size {blob.page_size} vs {self.page_size}, "
                f"quantized {blob.quantized} vs {self.quantized})"
            )
        if pages is None:
            pages = self.alloc(blob.n_pages)
        elif len(pages) != blob.n_pages:
            raise ValueError(f"resume reserved {len(pages)} pages for a {blob.n_pages}-page blob")
        device = _codes(self.k).device

        def to_device(chunks):
            if isinstance(chunks, dict):
                return {k: t.to(device) for k, t in chunks.items()}
            return chunks.to(device)

        scatter_pages(self.k, self.v, pages, to_device(blob.k_chunks), to_device(blob.v_chunks))
        observe_swap("in", blob.nbytes)
        return list(pages)


def page_slot(
    table: torch.Tensor, lengths: torch.Tensor, page_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The page-table addressing rule: token ``n`` of a request lives at
    ``(table[n // page_size], n % page_size)``. ``table`` [..., Jmax] and
    ``lengths`` [...] broadcast as in the JAX package."""
    table = torch.as_tensor(table, dtype=torch.int32)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=table.device)
    idx = (lengths // page_size).to(torch.int64)[..., None]
    table = table.expand(*idx.shape[:-1], table.shape[-1])
    pages = torch.gather(table, -1, idx)[..., 0]
    return pages, lengths % page_size


def write_token(
    pool_k: PoolLeaf,  # [L, P, Hkv, page, D], or {"q","s"}
    pool_v: PoolLeaf,
    page_table_row: torch.Tensor,  # [Jmax] int: one request's pages
    length,  # tokens already written: the slot this token takes
    k_vec: torch.Tensor,  # [L, Hkv, D]: this token's K across layers
    v_vec: torch.Tensor,
) -> Tuple[PoolLeaf, PoolLeaf]:
    """Append one token's K/V for one request at ``page_slot``'s address,
    in place; returns the pools. An int8 pool quantizes each vector with
    the decode step's scale math (``quantize_kv_vector``)."""
    page, slot = page_slot(page_table_row, length, _codes(pool_k).shape[3])
    page, slot = int(page), int(slot)

    def write(pool, vec):
        if isinstance(pool, dict):
            q, s = quantize_kv_vector(vec)  # [L,Hkv,D] int8, [L,Hkv] f32
            pool["q"][:, page, :, slot] = q
            pool["s"][:, page, :, slot] = s
        else:
            pool[:, page, :, slot] = vec.to(pool.dtype)
        return pool

    return write(pool_k, k_vec), write(pool_v, v_vec)


def _paginate(seq: torch.Tensor, s_real: int, page_size: int) -> torch.Tensor:
    """[L, Hkv, S, D] contiguous slab → [n_pages, L, Hkv, page, D] chunks,
    the tail page zero-padded."""
    n_pages = -(-s_real // page_size)
    seq = seq[:, :, :s_real]
    pad = n_pages * page_size - s_real
    if pad:
        seq = torch.nn.functional.pad(seq, (0, 0, 0, pad))
    l, hkv, _, d = seq.shape
    return seq.reshape(l, hkv, n_pages, page_size, d).permute(2, 0, 1, 3, 4)


def group_chunks(
    k_cache: torch.Tensor,  # [L, G, Hkv, T, D]: a grouped-prefill cache
    v_cache: torch.Tensor,
    rows: torch.Tensor,  # [R] int: group members to paginate
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page chunks of R rows of a grouped-prefill cache:
    [L,G,Hkv,T,D] → ([R·Tp, L, Hkv, page, D] ×2), in (row, page) order with
    Tp = ceil(T / page). Chunks past a row's real prompt carry what the
    prefill wrote at padded positions; callers send them to one garbage
    page, and attention masks by real length."""
    l, _, hkv, t, d = k_cache.shape
    tp = -(-t // page_size)
    rows = torch.as_tensor(rows, dtype=torch.int64, device=k_cache.device)
    r = rows.shape[0]

    def prep(c):
        c = c.index_select(1, rows)  # [L,R,Hkv,T,D]
        pad_t = tp * page_size - t
        if pad_t:
            c = torch.nn.functional.pad(c, (0, 0, 0, pad_t))
        c = c.reshape(l, r, hkv, tp, page_size, d)
        return c.permute(1, 3, 0, 2, 4, 5).reshape(r * tp, l, hkv, page_size, d)

    return prep(k_cache), prep(v_cache)


def quantize_chunks(
    k_chunks: torch.Tensor,  # [N, L, Hkv, page, D]
    v_chunks: torch.Tensor,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Per-position int8 quantization of page chunks for a quantized pool:
    ``{"q": int8 [N,L,Hkv,page,D], "s": f32 [N,L,Hkv,page]}``, with the
    scale math of ``quantize_kv_vector`` (the contiguous int8 cache's)."""
    kq, ks = quantize_kv_vector(k_chunks)
    vq, vs = quantize_kv_vector(v_chunks)
    return {"q": kq, "s": ks}, {"q": vq, "s": vs}


def scatter_pages(
    pool_k: PoolLeaf,  # [L, P, Hkv, page, D], or {"q","s"}
    pool_v: PoolLeaf,
    page_indices,  # [N] int: destination pool pages
    k_chunks,  # [N, L, Hkv, page, D], or {"q","s"}
    v_chunks,
) -> Tuple[PoolLeaf, PoolLeaf]:
    """Write N page chunks into the pool, one indexed copy per pool tensor,
    in place; returns the pools. A page named twice (the batch path's
    garbage page) receives one of its chunks, unspecified which, as in
    the JAX scatter."""
    codes = _codes(pool_k)
    idx = torch.as_tensor(page_indices, dtype=torch.int64, device=codes.device)

    def scatter(pool, chunks):
        if isinstance(pool, dict):
            pool["q"][:, idx] = chunks["q"].transpose(0, 1).to(torch.int8)
            pool["s"][:, idx] = chunks["s"].transpose(0, 1).to(torch.float32)
        else:
            pool[:, idx] = chunks.transpose(0, 1).to(pool.dtype)
        return pool

    return scatter(pool_k, k_chunks), scatter(pool_v, v_chunks)


def write_prefill(
    pool_k: PoolLeaf,
    pool_v: PoolLeaf,
    page_table_row: torch.Tensor,  # [Jmax] int
    k_seq: torch.Tensor,  # [L, Hkv, S, D]: one prefilled contiguous slab
    v_seq: torch.Tensor,
    s_real: int,
) -> Tuple[PoolLeaf, PoolLeaf]:
    """Scatter one request's prefilled K/V (its first ``s_real``
    positions) into the first ``ceil(s_real / page)`` pages of its table
    row with one indexed copy per pool tensor, in place; an int8 pool
    quantizes the chunks on the way in. Returns the pools."""
    page_size = _codes(pool_k).shape[3]
    n_pages = -(-s_real // page_size)
    k_chunks = _paginate(k_seq, s_real, page_size)
    v_chunks = _paginate(v_seq, s_real, page_size)
    if isinstance(pool_k, dict):
        k_chunks, v_chunks = quantize_chunks(k_chunks, v_chunks)
    return scatter_pages(pool_k, pool_v, page_table_row[:n_pages], k_chunks, v_chunks)
