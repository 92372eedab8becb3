"""Decoder-only transformer over a plain dict of stacked ``[L, ...]`` weights.

Counterpart of the JAX package's ``models/transformer.py`` for the solo,
contiguous-cache path: same leaf names and shapes, same layer math, a
Python loop over layers where the JAX package scans. One ``forward`` serves
prefill (S tokens at a scalar offset) and decode (S=1): the step's K/V are
written into the fixed-size cache — in place, unlike the JAX version, which
returns new caches — and attention masks by absolute position.

Caches are ``[L, B, Hkv, T, D]`` tensors, int8 ``{"q": [L,B,Hkv,T,D],
"s": [L,B,Hkv,T]}`` dicts, or a paged leaf (:func:`is_paged_cache`): the
stacked-hybrid leaf of the batch path (a read-only page pool holding the
prompts, plus side caches that take the tokens generated in this call),
or the write-through leaf ``{"pool", "table"}``, whose decode step
writes its K/V into the pool through the table and reads it back with
the normalised paged kernel (B6). A contiguous batch cache also decodes
one token per row at per-row offsets ``[B]`` (a speculative draft model's
cache) or, on the contiguous session's cache, the speculative verify
block of S = k+1 candidates per row; the stacked-hybrid leaf takes that
block too. A config with ``n_experts`` runs the mixture-of-experts MLP
(:func:`_moe_mlp`, the JAX package's dense dispatch). The JAX package's
kernel-less scratch verify leaf is not ported (the port's paged sessions
are stacked-hybrid, and B7/B8 serve every head width it runs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..engine.paged_kv import page_slot
from ..ops.attention import (
    _gather_pages,
    decode_attention_reference,
    prefill_attention_cached,
)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_angles
from .config import ModelConfig
from .quantize import (
    codes,
    dense_dot,
    dequant_cache,
    embed_lookup,
    is_quantized,
    is_quantized_cache,
    maybe_dequant,
    quantize_kv_vector,
    stack_layers,
)

Params = Dict[str, Any]

# Param leaves WITHOUT the leading stacked-layer [L, …] axis.
NON_LAYER_LEAVES = ("embed", "final_norm", "lm_head")

# (q[B,Hq,D], k_cache[B,Hkv,T,D], v_cache[B,Hkv,T,D], lengths[B] int32) -> [B,Hq,D];
# an int8 cache arrives as its {"q","s"} dict.
DecodeAttentionFn = Callable[..., torch.Tensor]
# (q[B,S,Hq,D], k_cache[B,Hkv,T,D], v_cache[B,Hkv,T,D], offset: int) -> [B,S,Hq,D]
PrefillAttentionFn = Callable[..., torch.Tensor]

STACKED_PAGED_KEYS = frozenset(
    {"pool", "table", "layer", "side", "side_layer", "write_pos", "prompt_lens"}
)


def is_paged_cache(leaf: Any) -> bool:
    """A paged KV-cache leaf: ``{"pool": [P,Hkv,page,D], "table": [B,Jmax]}``,
    pages of a shared pool addressed through a per-request block table.
    The STACKED-HYBRID variant (the batch path's) also carries a side
    cache ``side`` [B,Hkv,Tgen,D] (or int8 ``{"q","s"}``) for the tokens
    generated in this call, and ``write_pos``/``prompt_lens`` [B] row
    vectors; its pool holds only the prompts and is read-only during
    decode. At the engine boundary pool and side carry a leading [L] axis,
    and :func:`run_blocks` hands each layer its views. The key set is the
    JAX package's; the port runs only the stacked-hybrid variant without
    ``layer``/``side_layer``."""
    if not isinstance(leaf, dict):
        return False
    keys = set(leaf)
    return (
        keys == {"pool", "table"}
        or keys == {"pool", "table", "scratch"}
        or ({"pool", "table", "side"} <= keys <= STACKED_PAGED_KEYS)
    )


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    post: Optional[Callable[[str, torch.Tensor], Any]] = None,
) -> Params:
    """Random-init weights on the generator's device.

    ``post(name, leaf)`` is applied to each leaf as it is created, so a
    quantizing caller never holds the full-precision model at once. The
    generator draws each leaf whole, in leaf order, except the expert
    leaves of a mixture-of-experts config (``w_gate``, ``w_up``,
    ``w_down``, each ``[L, E, in, out]``): for each of them, in that
    order, one ``[E, in, out]`` draw per layer, which ``post`` sees alone
    and :func:`stack_layers` writes into the stacked leaf, so that float
    temporaries stay one layer's (mixtral's ``w_gate`` is 60 GB in f32);
    then ``router`` ``[L, D, E]`` (fan-in D) in one draw, before an untied
    ``lm_head``."""
    device = generator.device
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if post is None:
        post = lambda _name, leaf: leaf  # noqa: E731

    def normal(shape):
        return torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )

    def mat(shape, fan_in):
        return (normal(shape) / math.sqrt(fan_in)).to(dtype)

    def mlp(name, shape, fan_in):
        if not cfg.n_experts:
            return post(name, mat((l, *shape), fan_in))
        return stack_layers(l, lambda _i: post(name, mat((cfg.n_experts, *shape), fan_in)))

    def norm_gain(shape):
        fill = torch.zeros if cfg.gemma_norm else torch.ones
        return fill(shape, dtype=dtype, device=device)

    params: Params = {}
    params["embed"] = post("embed", (normal((cfg.vocab_size, d)) * 0.02).to(dtype))
    params["attn_norm"] = post("attn_norm", norm_gain((l, d)))
    params["wq"] = post("wq", mat((l, d, hq * dh), d))
    params["wk"] = post("wk", mat((l, d, hkv * dh), d))
    params["wv"] = post("wv", mat((l, d, hkv * dh), d))
    params["wo"] = post("wo", mat((l, hq * dh, d), hq * dh))
    params["mlp_norm"] = post("mlp_norm", norm_gain((l, d)))
    params["w_gate"] = mlp("w_gate", (d, f), d)
    params["w_up"] = mlp("w_up", (d, f), d)
    params["w_down"] = mlp("w_down", (f, d), f)
    params["final_norm"] = post("final_norm", norm_gain((d,)))
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            params[name] = post(
                name, torch.zeros((l, width), dtype=dtype, device=device)
            )
    if cfg.n_experts:
        params["router"] = post("router", mat((l, d, cfg.n_experts), d))
    if not cfg.tie_embeddings:
        params["lm_head"] = post("lm_head", mat((d, cfg.vocab_size), d))
    return params


def split_layers(params: Params) -> List[Params]:
    """Per-layer views of the stacked leaves (no copies)."""
    stacked = {k: v for k, v in params.items() if k not in NON_LAYER_LEAVES}
    first = next(iter(stacked.values()))
    n_layers = (codes(first) if is_quantized(first) else first).shape[0]

    def at(leaf, i):
        if is_quantized(leaf):  # int8, int4 or int4-i32: codes and scales
            return {k: t[i] for k, t in leaf.items()}
        return leaf[i]

    return [{k: at(v, i) for k, v in stacked.items()} for i in range(n_layers)]


def _is_write_through(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"pool", "table"}


def _cache_layer(cache, i: int):
    """Layer ``i``'s view of a stacked cache (no copy): of both tensors of
    an int8 dict, of the pool and side of a stacked-hybrid paged leaf,
    and of the pool of a write-through leaf (its [B,Jmax] table is
    shared by every layer)."""
    if _is_write_through(cache):
        return {"pool": _cache_layer(cache["pool"], i), "table": cache["table"]}
    if is_paged_cache(cache):
        if "side" not in cache or {"layer", "side_layer"} & set(cache):
            raise NotImplementedError(
                "the scratch paged leaf (the JAX package's kernel-less verify: the "
                "port's paged sessions are stacked-hybrid, and B7/B8 serve every "
                "head width it runs) and the layer= forms of the stacked-hybrid "
                "leaf are not ported"
            )
        return {
            **cache,
            "pool": _cache_layer(cache["pool"], i),
            "side": _cache_layer(cache["side"], i),
        }
    if isinstance(cache, dict):
        return {"q": cache["q"][i], "s": cache["s"][i]}
    return cache[i]


def _write_rows(cache, rows: torch.Tensor, pos: torch.Tensor, vec: torch.Tensor) -> None:
    """Write each row's vector ``vec [B,Hkv,D]`` at ``cache[row, :,
    pos[row]]`` of a [B,Hkv,T,D] cache (a side cache or a batch cache) in
    place, or, with ``rows [B,1]`` and ``pos [B,S]``, the block ``vec
    [B,S,Hkv,D]`` at ``cache[row, :, pos[row, j]]``; an int8 cache
    quantizes it with the decode-step scale math."""
    if isinstance(cache, dict):
        codes, scales = quantize_kv_vector(vec)
        cache["q"][rows, :, pos] = codes
        cache["s"][rows, :, pos] = scales
    else:
        cache[rows, :, pos] = vec.to(cache.dtype)


def _gather_paged(leaf) -> torch.Tensor:
    """A write-through layer's pool pages as a contiguous f32 [B,Hkv,
    Jmax·page,D] cache (int8: dequantized), read through the table: the
    gather path, taken without the paged decode callable."""
    pool, table = leaf["pool"], leaf["table"]
    if isinstance(pool, dict):
        codes = _gather_pages(pool["q"], table).to(torch.float32)
        return codes * _gather_pages(pool["s"], table).to(torch.float32)[..., None]
    return _gather_pages(pool, table).to(torch.float32)


def _write_through(
    k_cache: Dict[str, Any],  # one layer's {"pool", "table"}
    v_cache: Dict[str, Any],
    k: torch.Tensor,  # [B,Hkv,D]: this step's K
    v: torch.Tensor,
    offset: torch.Tensor,  # [B] positions the step writes
) -> None:
    """Write each row's step K/V into its pool page at ``page_slot``'s
    address, in place (int8 pools quantize with the decode step's scale
    math). Rows own disjoint pages, so the one indexed copy is exact."""
    pool = k_cache["pool"]
    page_size = (pool["q"] if isinstance(pool, dict) else pool).shape[-2]
    pages, slots = page_slot(k_cache["table"], offset, page_size)
    pages, slots = pages.long(), slots.long()
    for cache, vec in ((k_cache, k), (v_cache, v)):
        pool = cache["pool"]
        if isinstance(pool, dict):
            q, s = quantize_kv_vector(vec)
            pool["q"][pages, :, slots] = q
            pool["s"][pages, :, slots] = s
        else:
            pool[pages, :, slots] = vec.to(pool.dtype)


def _side_view(side) -> torch.Tensor:
    """A layer's side cache as f32 [B,Hkv,Tgen,D] (int8: dequantized)."""
    if isinstance(side, dict):
        return side["q"].to(torch.float32) * side["s"].to(torch.float32)[..., None]
    return side.to(torch.float32)


def _paged_attention(
    cfg: ModelConfig,
    q: torch.Tensor,  # [B,S,Hq,Dh]
    k: torch.Tensor,  # [B,S,Hkv,Dh]
    v: torch.Tensor,
    k_cache: Dict[str, Any],  # one layer's stacked-hybrid leaf
    v_cache: Dict[str, Any],
    decode_attention: Optional[DecodeAttentionFn],
) -> torch.Tensor:
    """A decode step (S = 1) or a speculative verify block (S = k+1) over
    the stacked-hybrid paged leaf: the block's K/V land in the side caches
    at each row's ``write_pos + j``; the prompt pages give unnormalised
    parts (``decode_attention``, the paged parts kernel, which takes the
    [B,S,Hq,D] block to its multi-query twin); the side term, under the
    per-query cut ``tpos <= write_pos + j``, and the exact online-softmax
    merge of the two are plain torch, as the JAX package does them in XLA
    outside its kernel. Returns [B,S,Hq,Dh] in f32."""
    b, s, hq, dh = q.shape
    if decode_attention is None:
        raise ValueError("a paged cache needs the paged parts attention callable")
    hkv = cfg.n_kv_heads
    group = hq // hkv
    wp = k_cache["write_pos"]  # [B] int64
    rows = torch.arange(b, device=q.device)
    scale = 1.0 / math.sqrt(dh)
    if s == 1:
        _write_rows(k_cache["side"], rows, wp, k[:, 0])
        _write_rows(v_cache["side"], rows, wp, v[:, 0])
        ks, vs = _side_view(k_cache["side"]), _side_view(v_cache["side"])
        qd = q[:, 0].contiguous()
        acc1, m1, l1 = decode_attention(qd, k_cache, v_cache, k_cache["prompt_lens"])
        qg = qd.reshape(b, hkv, group, dh).to(torch.float32)
        s2 = torch.einsum("bkgd,bktd->bkgt", qg, ks) * scale
        tpos = torch.arange(ks.shape[2], device=q.device)
        visible = (tpos[None, :] <= wp[:, None])[:, None, None, :]
        spec = "bkgt,bktd->bkgd"
    else:
        pos = wp[:, None] + torch.arange(s, device=q.device)  # [B,S]
        _write_rows(k_cache["side"], rows[:, None], pos, k)
        _write_rows(v_cache["side"], rows[:, None], pos, v)
        ks, vs = _side_view(k_cache["side"]), _side_view(v_cache["side"])
        acc1, m1, l1 = decode_attention(q.contiguous(), k_cache, v_cache, k_cache["prompt_lens"])
        acc1 = acc1.permute(0, 2, 3, 1, 4)  # [B,S,Hkv,G,D] -> [B,Hkv,G,S,D]
        m1 = m1.permute(0, 2, 3, 1)  # [B,Hkv,G,S]
        l1 = l1.permute(0, 2, 3, 1)
        qg = q.reshape(b, s, hkv, group, dh).to(torch.float32)
        s2 = torch.einsum("bskgd,bktd->bkgst", qg, ks) * scale
        tpos = torch.arange(ks.shape[2], device=q.device)
        visible = (tpos[None, None, :] <= pos[:, :, None])[:, None, None]  # [B,1,1,S,T]
        spec = "bkgst,bktd->bkgsd"
    s2 = torch.where(visible, s2, float("-inf"))
    m2 = torch.amax(s2, dim=-1)  # finite: the query's own token is column wp + j
    p2 = torch.exp(s2 - m2[..., None])
    l2 = torch.sum(p2, dim=-1)
    acc2 = torch.einsum(spec, p2, vs)
    m_t = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m_t)  # 0 for an empty prompt (m1 = -inf)
    w2 = torch.exp(m2 - m_t)
    out = (acc1 * w1[..., None] + acc2 * w2[..., None]) / (l1 * w1 + l2 * w2)[..., None]
    if s == 1:
        return out.reshape(b, 1, hq, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh)  # [B,Hkv,G,S,D] -> [B,S,Hq,D]


def _activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# The dense dispatch runs tokens in chunks that keep each [E, T, F]
# intermediate (gate, up, their product) at or below this many bytes.
MOE_CHUNK_BYTES = 1 << 30


def moe_route(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """Router of the MoE MLP over tokens ``x [T, D]``: f32 logits against
    ``router [D, E]``, softmax, the top-k probabilities renormalised.
    Returns (weights [T, k] f32, experts [T, k] int64), the highest
    probability first and, on equal ones, the lower expert first, as
    ``jax.lax.top_k`` orders them (a stable descending sort; ``torch.topk``
    does not promise that order)."""
    probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, : cfg.top_k_experts], top_i[:, : cfg.top_k_experts]
    return top_w / torch.sum(top_w, dim=-1, keepdim=True), top_i


def _moe_mlp(cfg: ModelConfig, h: torch.Tensor, layer: Params) -> torch.Tensor:
    """Mixtral-style top-k MoE MLP with the JAX package's dense dispatch:
    every expert computes every token, and a dense [T, E] combine tensor
    (the renormalised top-k weights, 0 elsewhere, cast to ``h.dtype``)
    contracts the expert axis. Static shapes, no host sync and a launch
    count that does not depend on the routing. The experts dequantize to
    ``h.dtype`` (never the int4 kernels: those take 2-D leaves), and the
    products run in ``h.dtype``. Tokens go in chunks, as many as keep an
    [E, T, F] tensor within MOE_CHUNK_BYTES; each token's output depends
    on that token alone."""
    b, s, d = h.shape
    e = cfg.n_experts
    w_gate = maybe_dequant(layer["w_gate"], h.dtype)  # [E, D, F]
    w_up = maybe_dequant(layer["w_up"], h.dtype)
    w_down = maybe_dequant(layer["w_down"], h.dtype)  # [E, F, D]
    chunk_tokens = max(1, MOE_CHUNK_BYTES // (e * cfg.d_ff * h.element_size()))
    x = h.reshape(b * s, d)
    out = torch.empty_like(x)
    for start in range(0, b * s, chunk_tokens):
        xc = x[start : start + chunk_tokens]
        top_w, top_i = moe_route(cfg, xc, layer["router"])
        combine = torch.zeros(
            (xc.shape[0], e), dtype=torch.float32, device=h.device
        ).scatter_(1, top_i, top_w).to(h.dtype)
        gate = _activation(cfg, torch.matmul(xc, w_gate))  # [E, T, F]
        y = torch.matmul(gate * torch.matmul(xc, w_up), w_down)  # [E, T, D]
        out[start : start + chunk_tokens] = torch.einsum("te,etd->td", combine, y)
    return out.reshape(b, s, d)


def _attention_block(
    cfg: ModelConfig,
    x: torch.Tensor,  # [B,S,D]
    layer: Params,
    k_cache,  # [B,Hkv,T,Dh], int8 {"q","s"} or a paged leaf; written in place
    v_cache,
    offset,  # cache position of token 0: int, or [B] per-row positions
    cos: torch.Tensor,  # [B,S,half]
    sin: torch.Tensor,
    decode_attention: Optional[DecodeAttentionFn],
    prefill_attention: Optional[PrefillAttentionFn],
    lengths: Optional[torch.Tensor],  # [B] int32 = offset + S (decode or per-row verify, not paged)
) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    q = dense_dot(x, layer["wq"])
    k = dense_dot(x, layer["wk"])
    v = dense_dot(x, layer["wv"])
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    q = apply_rope(q.reshape(b, s, hq, dh), cos, sin)
    k = apply_rope(k.reshape(b, s, hkv, dh), cos, sin)
    v = v.reshape(b, s, hkv, dh)

    if _is_write_through(k_cache):
        # Write-through decode: one token per row at a shared or per-row
        # offset; prefill runs contiguous and is scattered into the pool.
        if s != 1:
            raise ValueError(
                "write-through paged caches take single-token decode steps only "
                "(prefill runs contiguous and is scattered into the pool; the "
                "speculative verify rides the stacked-hybrid leaf)"
            )
        off = torch.as_tensor(offset, device=x.device).expand(b)
        _write_through(k_cache, v_cache, k[:, 0], v[:, 0], off)  # before the read
        if decode_attention is not None:
            out = decode_attention(q[:, 0], k_cache, v_cache, lengths)
        else:
            out = decode_attention_reference(
                q[:, 0], _gather_paged(k_cache), _gather_paged(v_cache), (off + 1).to(torch.int32)
            )
        return dense_dot(out.to(x.dtype).reshape(b, s, hq * dh), layer["wo"])

    if is_paged_cache(k_cache):
        out = _paged_attention(cfg, q, k, v, k_cache, v_cache, decode_attention)
        out = out.to(x.dtype).reshape(b, s, hq * dh)
        return dense_dot(out, layer["wo"])

    if isinstance(offset, torch.Tensor):
        # Per-row positions [B] on a batch cache (the JAX package's
        # carry-resident branch): one token per row (a decode step, a
        # speculative draft's), or the contiguous verify block of S = k+1
        # candidates per row, written at offset[b] + j; query j then sees
        # kpos <= offset[b] + j (``lengths`` = offset + S).
        if decode_attention is None:
            raise ValueError("per-row offsets on a contiguous cache need the decode attention callable")
        rows = torch.arange(b, device=x.device)
        if s == 1:
            _write_rows(k_cache, rows, offset, k[:, 0])
            _write_rows(v_cache, rows, offset, v[:, 0])
            out = decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]
        else:
            pos = offset[:, None] + torch.arange(s, device=x.device)
            _write_rows(k_cache, rows[:, None], pos, k)
            _write_rows(v_cache, rows[:, None], pos, v)
            out = decode_attention(q, k_cache, v_cache, lengths)
        return dense_dot(out.to(x.dtype).reshape(b, s, hq * dh), layer["wo"])

    span = slice(offset, offset + s)
    if is_quantized_cache(k_cache):
        # int8 cache: the new entries quantize with the per-vector scale
        # math of the bulk post-prefill quantization.
        for cache, new in ((k_cache, k), (v_cache, v)):
            codes, scales = quantize_kv_vector(new.transpose(1, 2))
            cache["q"][:, :, span] = codes
            cache["s"][:, :, span] = scales
    else:
        k_cache[:, :, span] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[:, :, span] = v.transpose(1, 2).to(v_cache.dtype)

    if s == 1 and decode_attention is not None:
        out = decode_attention(q[:, 0], k_cache, v_cache, lengths)[:, None]
    elif s > 1 and prefill_attention is not None:
        out = prefill_attention(q, k_cache, v_cache, offset)
    else:
        kf = dequant_cache(k_cache) if isinstance(k_cache, dict) else k_cache
        vf = dequant_cache(v_cache) if isinstance(v_cache, dict) else v_cache
        out = prefill_attention_cached(q, kf, vf, offset)
    out = out.to(x.dtype).reshape(b, s, hq * dh)
    return dense_dot(out, layer["wo"])


def run_blocks(
    layers: List[Params],
    cfg: ModelConfig,
    x: torch.Tensor,  # [B,S,D] embedded inputs
    offset,  # int, or [B] per-row positions
    k_cache,  # [L,B,Hkv,T,Dh], int8 {"q","s"} or a stacked paged leaf
    v_cache,
    cos: torch.Tensor,
    sin: torch.Tensor,
    decode_attention: Optional[DecodeAttentionFn] = None,
    prefill_attention: Optional[PrefillAttentionFn] = None,
) -> torch.Tensor:
    """Run the transformer blocks over ``x``, one layer at a time; layer
    ``i`` gets its views of the caches (for a paged leaf, ``pool[i]`` and
    ``side[i]``, no copy)."""
    b, s, _ = x.shape
    lengths = None
    stacked_hybrid = is_paged_cache(k_cache) and not _is_write_through(k_cache)
    if decode_attention is not None and not stacked_hybrid:
        if isinstance(offset, torch.Tensor):  # per-row positions: S = 1, or a verify block
            lengths = (offset + s).to(torch.int32)
        elif s == 1:
            lengths = torch.full((b,), offset + 1, dtype=torch.int32, device=x.device)
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)
        x = x + _attention_block(
            cfg, h, layer, _cache_layer(k_cache, i), _cache_layer(v_cache, i),
            offset, cos, sin, decode_attention, prefill_attention, lengths,
        )
        h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)
        if cfg.n_experts:
            x = x + _moe_mlp(cfg, h, layer)
        else:
            gate = _activation(cfg, dense_dot(h, layer["w_gate"]))
            x = x + dense_dot(gate * dense_dot(h, layer["w_up"]), layer["w_down"])
    return x


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B,S] int
    offset,  # int; or [B] int tensor, one position per row
    k_cache,  # [L,B,Hkv,T,Dh], int8 {"q","s"} or a paged leaf; updated in place
    v_cache,
    decode_attention: Optional[DecodeAttentionFn] = None,
    prefill_attention: Optional[PrefillAttentionFn] = None,
    layers: Optional[List[Params]] = None,
) -> Tuple[torch.Tensor, Any, Any]:
    """Run the stack over S tokens starting at cache position ``offset``.

    Returns (hidden [B,S,D], k_cache, v_cache); the caches are the ones
    passed in, written in place. ``layers`` takes precomputed
    :func:`split_layers` views, so a decode loop need not rebuild them
    every step. Without attention callables, attention runs the plain
    masked path (dequantizing an int8 cache)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, params["final_norm"].dtype)
    if cfg.gemma_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    steps = torch.arange(s, dtype=torch.int32, device=x.device)
    if isinstance(offset, torch.Tensor):  # per-row positions [B]
        positions = offset.to(torch.int32)[:, None] + steps[None, :]
    else:
        positions = (offset + steps).expand(b, s)
    cos, sin = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    if layers is None:
        layers = split_layers(params)
    x = run_blocks(
        layers, cfg, x, offset, k_cache, v_cache, cos, sin,
        decode_attention, prefill_attention,
    )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)
    return x, k_cache, v_cache


def logits_for(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden states [..., D] to vocab logits in float32.

    A quantized head dequantizes to bf16 operands whose products are
    summed in float32, as the JAX package does; a full-precision head
    stays all-float32."""
    leaf = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if is_quantized(leaf):
        head = maybe_dequant(leaf, torch.bfloat16).to(torch.float32)
        h = hidden.to(torch.bfloat16).to(torch.float32)
    else:
        head = leaf.to(torch.float32)
        h = hidden.to(torch.float32)
    return h @ (head.T if cfg.tie_embeddings else head)


@dataclasses.dataclass
class Transformer:
    """Config + params bundle, with the per-layer views cached."""

    cfg: ModelConfig
    params: Params

    def __post_init__(self) -> None:
        self.layers = split_layers(self.params)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"].device

    def init_cache(
        self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (self.cfg.n_layers, batch, self.cfg.n_kv_heads, max_len, self.cfg.d_head)
        return (
            torch.zeros(shape, dtype=dtype, device=self.device),
            torch.zeros(shape, dtype=dtype, device=self.device),
        )
