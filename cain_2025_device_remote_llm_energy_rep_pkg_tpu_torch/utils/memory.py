"""Weight-size and decode-stream byte estimates (the byte model).

The byte half of the JAX package's ``utils/memory.py``: how many bytes a
model's weights hold under each quantization mode, and how many bytes one
single-row decode step streams from device memory (weights and KV cache).
The energy model (``profilers/nvml.py::GpuEnergyModelProfiler``, through
``experiments/llm_energy.py::generation_stats_from``) bills its memory
duty from these bytes, and the tensor-parallel roofline
(``parallel/roofline.py``) its decode time. The formulas equal the JAX
package's, so both packages bill the same work.

The device-budget half (probing what the card can allocate before a
load) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

# The operator override of the probed device budget, named in the error
# below (the JAX package's variable; the port's probe is not ported yet).
ENV_OVERRIDE = "TPU_MEMORY_BUDGET_BYTES"


def _per_layer_weight_terms(cfg, experts: int):
    """The per-layer parameter accounting shared by residency
    (:func:`estimate_weight_bytes`) and decode streaming
    (:func:`decode_weight_stream_bytes`) — ONE implementation of the
    quantization byte rules, parameterised only by how many experts
    count (all resident vs top-k streamed). Returns
    ``(matmul_per_layer, matmul_out_channels, norms_biases)`` in
    parameter counts."""
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    matmul_per_layer = (
        d * hq * dh  # wq
        + 2 * d * hkv * dh  # wk, wv
        + hq * dh * d  # wo
        + 3 * d * f * experts  # gate, up, down
        + (d * cfg.n_experts if cfg.n_experts else 0)  # router
    )
    matmul_out_channels = (
        hq * dh + 2 * hkv * dh + d + (2 * f + d) * experts
    )  # scale entries per layer (per output channel)
    norms_biases = 2 * l * d + d  # attn/mlp norms + final norm
    if cfg.qkv_bias:
        norms_biases += l * (hq * dh + 2 * hkv * dh)
    return matmul_per_layer, matmul_out_channels, norms_biases


def estimate_weight_bytes(
    cfg, quantize: Optional[str], dtype_bytes: int = 2
) -> int:
    """Estimated HBM bytes of one model's parameters under the engine's
    quantization rules (models/quantize.py): matmul weights at the mode's
    width (int8 = 1 B, int4 = 0.5 B + f32 per-output-channel scales),
    embeddings/lm_head at int8 in every quantized mode, norms and biases
    at full precision.
    """
    d, l = cfg.d_model, cfg.n_layers
    matmul_per_layer, matmul_out_channels, norms_biases = (
        _per_layer_weight_terms(cfg, experts=max(1, cfg.n_experts))
    )

    embed_params = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if quantize is None:
        return dtype_bytes * (
            embed_params + l * matmul_per_layer + norms_biases
        )
    weight_b = 1.0 if quantize == "int8" else 0.5
    # per-row embed scales (f32): the int8 embedding table carries one, and
    # an untied lm_head carries its own (quantize.py stores both)
    embed_scale_rows = cfg.vocab_size * (1 if cfg.tie_embeddings else 2)
    return int(
        embed_params  # int8 in both modes
        + 4 * embed_scale_rows
        + l * matmul_per_layer * weight_b
        + 4 * l * matmul_out_channels  # per-output-channel scales (f32)
        + dtype_bytes * norms_biases
    )


def decode_weight_stream_bytes(
    cfg, quantize: Optional[str], dtype_bytes: int = 2
) -> float:
    """HBM bytes of WEIGHTS streamed by one single-row decode step.

    Matches :func:`estimate_weight_bytes`'s quantization rules, with two
    decode-specific differences:

    - the embedding table is read ONCE as the logits head (a full
      ``vocab×d`` stream), never a second time for the input token — that
      is a single-row gather, not a stream;
    - only the routed ``top_k_experts`` of an MoE layer are streamed per
      token (matching ``flops_per_token``'s active-expert accounting).
    """
    d, l = cfg.d_model, cfg.n_layers
    matmul_per_layer, matmul_out_channels, norms_biases = (
        _per_layer_weight_terms(
            cfg, experts=cfg.top_k_experts if cfg.n_experts else 1
        )
    )

    if quantize is None:
        return float(
            dtype_bytes
            * (cfg.vocab_size * d + l * matmul_per_layer + norms_biases)
        )
    weight_b = 1.0 if quantize == "int8" else 0.5
    return float(
        cfg.vocab_size * d  # logits head: int8 in every quantized mode
        + 4 * cfg.vocab_size  # its per-row f32 scales
        + l * matmul_per_layer * weight_b
        + 4 * l * matmul_out_channels  # per-output-channel f32 scales
        + dtype_bytes * norms_biases
    )


def decode_kv_stream_bytes(
    cfg,
    context_len: int,
    kv_quantize: Optional[str] = None,
    dtype_bytes: int = 2,
) -> float:
    """HBM bytes of KV CACHE read by one single-row decode step at the
    given context (the per-step single-position write is negligible and
    excluded). Kept as the single source of the KV formula — the TP
    roofline needs the weight/KV split because sharding treats them
    differently (KV replicates when heads don't divide the mesh)."""
    l, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    kv_b = 1 if kv_quantize == "int8" else dtype_bytes
    kv_bytes = 2 * l * hkv * dh * context_len * kv_b
    if kv_quantize == "int8":
        kv_bytes += 2 * l * hkv * context_len * 4  # per-position f32 scales
    return float(kv_bytes)


# Elementwise ops per PACKED WEIGHT BYTE to turn the quantized stream into
# matmul operands: int4 halves layout 5 (sign extension and converts per
# nibble pair), int4-i32 3, int8 1 (one convert per byte); bf16 streams
# are operands already. The counts are the JAX package's, kept so that
# both packages bill the same stats. On the H100 this is CUDA-core work:
# the int4 kernels (``csrc/int4_matmul.cu``) turn nibbles into bf16 pairs
# in registers, and int8 weights dequantize in eager torch ops; the port
# has not measured its own ops per byte.
VPU_UNPACK_OPS_PER_BYTE = {
    "int8": 1.0,
    "int4": 5.0,
    "int4-i32": 3.0,
}


def decode_vpu_unpack_ops_per_step(cfg, quantize: Optional[str]) -> float:
    """Elementwise ops one decode step spends unpacking the quantized
    weight stream (the bytes × per-byte cost above): the third duty term
    of the energy model, billed on the H100 against the CUDA cores'
    non-tensor rate (``profilers/nvml.py``)."""
    if quantize is None:
        return 0.0
    ops = VPU_UNPACK_OPS_PER_BYTE.get(quantize)
    if ops is None:
        return 0.0
    # only the matmul weight stream is unpacked in-kernel; scales, norms
    # and the (int8) logits head are charged at the int8 rate
    matmul_per_layer, _, _ = _per_layer_weight_terms(
        cfg, experts=cfg.top_k_experts if cfg.n_experts else 1
    )
    weight_b = 1.0 if quantize == "int8" else 0.5
    body_bytes = cfg.n_layers * matmul_per_layer * weight_b
    head_bytes = cfg.vocab_size * cfg.d_model  # int8 in every mode
    return float(body_bytes * ops + head_bytes * 1.0)


def estimate_decode_read_bytes_per_step(
    cfg,
    quantize: Optional[str],
    context_len: int,
    kv_quantize: Optional[str] = None,
    dtype_bytes: int = 2,
) -> float:
    """HBM bytes READ by one single-row decode step (single chip).

    Decode is memory-bound: every step streams the full weight set once
    plus the KV cache up to ``context_len``. This is the bytes term of the
    energy model's bandwidth duty cycle (profilers/nvml.py) and of the TP
    decode-time roofline (parallel/roofline.py).
    """
    return decode_weight_stream_bytes(
        cfg, quantize, dtype_bytes=dtype_bytes
    ) + decode_kv_stream_bytes(
        cfg, context_len, kv_quantize=kv_quantize, dtype_bytes=dtype_bytes
    )


class ModelMemoryError(RuntimeError):
    """A model's estimated weight bytes exceed the probed device budget."""

    def __init__(self, model: str, estimated: int, budget: int, hint: str) -> None:
        super().__init__(
            f"{model}: estimated weight footprint "
            f"{estimated / 1024**3:.2f} GiB exceeds the device budget "
            f"{budget / 1024**3:.2f} GiB — {hint} "
            f"(override the probed budget with {ENV_OVERRIDE}=<bytes>)"
        )
        self.model = model
        self.estimated = estimated
        self.budget = budget
