"""Weight-only quantization (int8 and packed int4) and the int8 KV cache.

Counterpart of the JAX package's ``models/quantize.py``. Quantized leaves
are dicts, scales per output channel:

- int8: ``{"q": int8[..., in, out], "s": f32[..., 1, out]}``, or for
  embeddings ``{"q": int8[V, D], "s": f32[V, 1]}`` (per row);
- int4 (halves): ``{"q4": int8[..., in/2, out], "s": f32[..., 1, out]}``,
  symmetric in [-7, 7]; packed row i carries weight row i in its low
  nibble and row i + in/2 in its high nibble;
- int4-i32: ``{"q32": int32[..., in/8, out], "s": f32[..., 1, out]}``;
  nibble p of lane k is weight row 8k + p.

Embeddings and an untied ``lm_head`` stay int8 in every mode. Both
frameworks round half to even, so the codes equal the JAX package's bit for
bit.

:func:`dense_dot` routes a decode-shaped int4 matmul (B·S <= 8 rows) to the
hand-written kernels of ``ops/cuda_quant.py`` by the JAX package's own
predicates; every other quantized matmul dequantizes and calls
``torch.matmul``, as the JAX package leaves that product to XLA outside any
kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch

from ..ops.cuda_quant import cuda_int4_matmul, cuda_int4_matmul_i32
from ..ops.quant import MAX_KERNEL_ROWS, int4_matmul_supported, unpack_int4, unpack_int4_i32

QuantLeaf = Dict[str, torch.Tensor]

# The matmul weights worth quantizing ([L, in, out]-shaped); norms and
# biases stay high-precision.
DEFAULT_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_MODES = ("int8", "int4", "int4-i32")
_CODE_KEYS = ("q", "q4", "q32")  # one per leaf form, beside its scales "s"
_LEAF_KEYS = tuple({k, "s"} for k in _CODE_KEYS)


def _scale(wf: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    # Times the float32 reciprocal, not divided by qmax: XLA rewrites the
    # JAX package's jitted ``/ qmax`` so, and the scales then agree bit
    # for bit.
    max_abs = torch.amax(torch.abs(wf), dim=dim, keepdim=True)
    return torch.clamp_min(max_abs, 1e-8) * (1.0 / qmax)


def _quantize(w: torch.Tensor, dim: int) -> QuantLeaf:
    wf = w.to(torch.float32)
    scale = _scale(wf, dim, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_tensor(w: torch.Tensor) -> QuantLeaf:
    """Symmetric int8, scales per output channel: the input-feature axis
    is ``-2`` for both stacked ``[L, in, out]`` and flat ``[in, out]``."""
    return _quantize(w, -2)


def quantize_tensor_rowwise(w: torch.Tensor) -> QuantLeaf:
    """Symmetric int8 with one scale per row — embedding tables [V, D]."""
    return _quantize(w, -1)


def _int4_codes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 4-bit codes in [-7, 7] (int32) and per-output-channel
    scales."""
    wf = w.to(torch.float32)
    scale = _scale(wf, -2, 7.0)
    return torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32), scale


def quantize_tensor_int4(w: torch.Tensor) -> QuantLeaf:
    """int4 in [-7, 7], the (even) input-feature axis packed as halves."""
    if w.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even input-feature dim, got {tuple(w.shape)}")
    half = w.shape[-2] // 2
    q, scale = _int4_codes(w)
    packed = (q[..., :half, :] & 0xF) | ((q[..., half:, :] & 0xF) << 4)  # 0..255
    return {"q4": packed.to(torch.uint8).view(torch.int8), "s": scale}


def quantize_tensor_int4_i32(w: torch.Tensor) -> QuantLeaf:
    """int4 in [-7, 7], eight k-consecutive nibbles per int32 lane. The
    lane is built in int64 and narrowed with wraparound, so a nibble at
    bit 28 sets the sign bit exactly as the JAX package's int32 ``|``/``<<``
    do."""
    if w.shape[-2] % 8:
        raise ValueError(
            f"i32 nibble packing needs an input-feature dim divisible by 8, got {tuple(w.shape)}"
        )
    q, scale = _int4_codes(w)
    qg = q.to(torch.int64).reshape(*q.shape[:-2], q.shape[-2] // 8, 8, q.shape[-1])
    lane = torch.zeros(qg.shape[:-2] + qg.shape[-1:], dtype=torch.int64, device=w.device)
    for p in range(8):
        lane |= (qg[..., p, :] & 0xF) << (4 * p)  # 0 .. 2^32 - 1
    lane = torch.where(lane >= 2**31, lane - 2**32, lane)
    return {"q32": lane.to(torch.int32), "s": scale}


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) in _LEAF_KEYS


def codes(leaf: QuantLeaf) -> torch.Tensor:
    """The code tensor of a quantized leaf, whichever its form."""
    return next(leaf[k] for k in _CODE_KEYS if k in leaf)


def maybe_dequant(
    leaf: Union[torch.Tensor, QuantLeaf], dtype=torch.bfloat16
) -> torch.Tensor:
    """Dequantize a quantized leaf of any form (or pass a plain tensor
    through)."""
    if not is_quantized(leaf):
        return leaf
    if "q4" in leaf:
        q = unpack_int4(leaf["q4"])
    elif "q32" in leaf:
        q = unpack_int4_i32(leaf["q32"])
    else:
        q = leaf["q"]
    return (q.to(torch.float32) * leaf["s"]).to(dtype)


def dense_dot(x: torch.Tensor, leaf: Union[torch.Tensor, QuantLeaf]) -> torch.Tensor:
    """``x [B,S,IN] @ weight [IN,OUT]`` for any leaf form.

    The JAX package's routing, predicate for predicate: a 2-D ``q4`` leaf
    with B·S <= 8 and ``int4_matmul_supported`` goes to kernel B9, a 2-D
    ``q32`` leaf with B·S <= 8 and OUT % 128 == 0 to kernel B10; everything
    else dequantizes and calls
    ``torch.matmul``. The kernel route rounds ``x`` to bf16, so identical
    routing keeps float32 tokens equal to the JAX engine's."""
    if is_quantized(leaf):
        b, s, d = x.shape
        if "q4" in leaf and leaf["q4"].ndim == 2:
            in_half, out_dim = leaf["q4"].shape
            if int4_matmul_supported(b * s, in_half, out_dim):
                out = cuda_int4_matmul(x.reshape(b * s, d).contiguous(), leaf["q4"], leaf["s"])
                return out.reshape(b, s, out_dim)
        if "q32" in leaf and leaf["q32"].ndim == 2:
            out_dim = leaf["q32"].shape[1]
            if b * s <= MAX_KERNEL_ROWS and out_dim % 128 == 0:
                out = cuda_int4_matmul_i32(x.reshape(b * s, d).contiguous(), leaf["q32"], leaf["s"])
                return out.reshape(b, s, out_dim)
    return torch.matmul(x, maybe_dequant(leaf, x.dtype))


def embed_lookup(
    leaf: Union[torch.Tensor, QuantLeaf], tokens: torch.Tensor, dtype
) -> torch.Tensor:
    """Row-gather from a (possibly int8) embedding table without
    materialising the dequantized table."""
    if is_quantized(leaf):  # per-row scales [V, 1]
        return (leaf["q"][tokens].to(torch.float32) * leaf["s"][tokens]).to(dtype)
    return leaf[tokens]


def stack_layers(n: int, layer: Callable[[int], Any]) -> Any:
    """``layer(i)`` for ``i < n`` stacked on a new leading axis. Each part
    (a tensor, or a quantized leaf's codes and scales) is written into
    tensors allocated once from layer 0's shapes, so only one layer's part
    exists beside the stacked leaf, never a list of all of them."""
    out = None
    for i in range(n):
        part = layer(i)
        is_leaf = isinstance(part, dict)
        parts = part if is_leaf else {None: part}
        if out is None:
            out = {k: t.new_empty((n, *t.shape)) for k, t in parts.items()}
        for k, t in parts.items():
            out[k][i] = t
        del part, parts
    return out if is_leaf else out[None]


def _per_layer(fn, w: torch.Tensor) -> QuantLeaf:
    """``fn`` over a stacked ``[L, ...]`` leaf one layer at a time (the
    scales are per layer and output channel, so the result is the same),
    so that the float32 temporaries of a full-width model stay one layer's:
    an MoE leaf ``[L, E, in, out]`` goes one ``[E, in, out]`` layer, and
    within it one expert, at a time."""
    if w.ndim < 3:
        return fn(w)
    return stack_layers(w.shape[0], lambda i: _per_layer(fn, w[i]))


def quantize_leaf(name: str, leaf: Any, mode: str = "int8", keys=DEFAULT_QUANT_KEYS) -> Any:
    """The per-leaf rule: named matmul weights at ``mode``, embeddings at
    int8 per row, an untied lm_head at int8 per output channel, everything
    else passes through."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    if is_quantized(leaf):
        return leaf
    if name in keys:
        fn = {
            "int8": quantize_tensor,
            "int4": quantize_tensor_int4,
            "int4-i32": quantize_tensor_int4_i32,
        }[mode]
        return _per_layer(fn, leaf)
    if name == "lm_head":
        return quantize_tensor(leaf)
    if name == "embed":
        return quantize_tensor_rowwise(leaf)
    return leaf


def quantize_params(
    params: Dict[str, Any], keys=DEFAULT_QUANT_KEYS, mode: str = "int8"
) -> Dict[str, Any]:
    """Quantize a whole parameter dict via :func:`quantize_leaf`."""
    return {
        name: quantize_leaf(name, leaf, mode, keys) for name, leaf in params.items()
    }


def params_nbytes(params: Dict[str, Any]) -> int:
    """Bytes of every leaf, codes and scales included."""
    total = 0
    for leaf in params.values():
        tensors = leaf.values() if is_quantized(leaf) else (leaf,)
        total += sum(t.numel() * t.element_size() for t in tensors)
    return total


# -- KV-cache quantization ----------------------------------------------------
# One scale per (..., position) vector; the decode kernel dequantizes K by
# scaling scores and V by scaling probabilities.


def quantize_kv_vector(vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cache entries ``[..., D]`` → (int8 codes, f32 scales [...])."""
    vf = vec.to(torch.float32)
    s = torch.clamp_min(torch.amax(torch.abs(vf), dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(vf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def quantize_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor):
    """Cache ``[..., T, D]`` → ``{"q": int8 [..., T, D], "s": f32 [..., T]}``
    for K and V. Unwritten (zero) positions get the epsilon scale and zero
    codes — masked by position in attention anyway."""

    def one(c):
        q, s = quantize_kv_vector(c)
        return {"q": q, "s": s}

    return one(k_cache), one(v_cache)


def is_quantized_cache(leaf: Any) -> bool:
    return (
        isinstance(leaf, dict)
        and set(leaf) == {"q", "s"}
        and leaf["q"].ndim == leaf["s"].ndim + 1
    )


def dequant_cache(leaf, dtype=torch.float32) -> torch.Tensor:
    """Materialise a quantized cache back to ``dtype`` (the path without a
    decode kernel; the kernels never materialise it)."""
    return (leaf["q"].to(torch.float32) * leaf["s"][..., None]).to(dtype)
