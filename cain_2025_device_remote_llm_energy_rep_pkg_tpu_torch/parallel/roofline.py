"""Roofline model of tensor-parallel decode time on an 8-GPU NVLink node.

The study's ``remote`` treatment stands for a bigger server
(``experiments/llm_energy.py``: ``remote`` bills 8 devices). On the H100
that server is an 8-GPU node whose GPUs are joined all to all through
NVSwitch. With one card, ``remote`` rows are *measured* on that card, and
this module models what the node's decode duration would be, so that an
aliased ``remote`` row carries an honest ``remote_modeled_decode_s``: the
study bills the node's power over the node's window, not over the single
card's.

Model (single-row greedy decode, the study's workload); the terms and
their counts are the JAX package's, the constants the H100's:

- **Memory term.** Decode streams the whole weight set and the KV cache
  every step (``utils/memory.estimate_decode_read_bytes_per_step``).
  Megatron-style tensor parallelism shards every matmul over ``n``
  devices, so each streams ``1/n`` of the weights; the KV cache is
  head-sharded only when ``n_kv_heads % n == 0`` and is replicated
  otherwise, and replicated cache bytes do not shrink with the node. The
  per-device rate is :data:`SUSTAINED_HBM_GBPS`.
- **Collective term.** Per step: one all-reduce of a ``d_model`` vector
  after ``wo`` and one after ``w_down`` in every layer, one for the
  logits, and two small all-gathers (embedding and argmax resharding):
  ``2·L + 1`` all-reduces and 2 all-gathers at the latency floor. With a
  replicated KV cache every layer also gathers one cache slice
  (``T·d_head`` elements) and each step four single-position slices. A
  ring step costs :data:`NVLINK_HOP_LATENCY_S` plus its payload over
  :data:`NVLINK_GBPS`.

The study uses only the ratio of the ``n``-device time to the
one-device time (``generation_stats_from``), anchored on the row's own
measured single-card decode; the constants below set that ratio. One
H100 streams a small model's weights in less time than the ``2·L + 1``
all-reduces' latency floor, so for the study's smaller models the model
bills the node slower than one card (``generation_stats_from`` warns).
"""

from __future__ import annotations

from typing import Optional

from ..models.config import ModelConfig
from ..utils.memory import decode_kv_stream_bytes, decode_weight_stream_bytes

# Device-memory rate of one H100 SXM: 3.35 TB/s of HBM3 (NVIDIA H100
# Tensor Core GPU data sheet, SXM column). This is the data sheet's rate,
# not a sustained decode stream: the port has not measured one.
SUSTAINED_HBM_GBPS = 3350.0
# NVLink bandwidth of one H100 SXM in ONE direction: the data sheet gives
# 900 GB/s for its 18 NVLink 4 links, both directions together; an
# NVSwitch node gives every GPU that rate to every other.
NVLINK_GBPS = 450.0
# Latency of one ring step of a small collective across NVSwitch:
# modelled, not in the data sheet and not measured (the port runs on one
# card). A step is a store across NVLink and the receiving kernel's poll
# of its flag; taken as 1.5 µs, so that an 8-device ring all-reduce (14
# steps) of a few KB costs about 21 µs, bounded within [0.75, 3] µs.
NVLINK_HOP_LATENCY_S = 1.5e-6
NVLINK_HOP_LATENCY_S_BOUNDS = (0.75e-6, 3e-6)


def allreduce_cost_s(payload_bytes: float, n_chips: int) -> float:
    """Ring all-reduce wall time for one ``payload_bytes`` tensor."""
    if n_chips <= 1:
        return 0.0
    hops = 2 * (n_chips - 1)  # reduce-scatter + all-gather phases
    bw = NVLINK_GBPS * 1e9
    return hops * NVLINK_HOP_LATENCY_S + 2 * (n_chips - 1) / n_chips * (
        payload_bytes / bw
    )


def allgather_cost_s(payload_bytes: float, n_chips: int) -> float:
    """Ring all-gather wall time: ONE phase of n-1 hops (an all-reduce
    without the reduce-scatter half)."""
    if n_chips <= 1:
        return 0.0
    bw = NVLINK_GBPS * 1e9
    return (n_chips - 1) * NVLINK_HOP_LATENCY_S + (n_chips - 1) / n_chips * (
        payload_bytes / bw
    )


def modeled_tp_decode_step_s(
    cfg: ModelConfig,
    quantize: Optional[str],
    n_chips: int,
    context_len: int,
    kv_quantize: Optional[str] = None,
    sustained_gbps: Optional[float] = None,
) -> float:
    """Modelled seconds for ONE decode step on ``n_chips`` tensor-parallel
    devices (``sustained_gbps`` defaults to :data:`SUSTAINED_HBM_GBPS`)."""
    if sustained_gbps is None:
        sustained_gbps = SUSTAINED_HBM_GBPS
    weight_bytes = decode_weight_stream_bytes(cfg, quantize)
    kv_bytes = decode_kv_stream_bytes(cfg, context_len, kv_quantize=kv_quantize)
    kv_sharded = n_chips > 1 and cfg.n_kv_heads % n_chips == 0
    per_chip_bytes = weight_bytes / n_chips + (
        kv_bytes / n_chips if kv_sharded else kv_bytes
    )
    t_mem = per_chip_bytes / (sustained_gbps * 1e9)
    # 2 all-reduces a layer (wo, w_down) + 1 logits combine, at ring
    # all-reduce cost; + 2 all-gathers (embedding and argmax resharding)
    # at single-phase gather cost.
    t_net = (2 * cfg.n_layers + 1) * allreduce_cost_s(
        cfg.d_model * 2, n_chips
    ) + 2 * allgather_cost_s(cfg.d_model * 2, n_chips)
    if not kv_sharded and n_chips > 1:
        # A replicated KV cache gathers one cache slice (T·d_head) a
        # layer, plus 4 single-position gathers a step that reshard the
        # new token's K/V; the payload shrinks with an int8 cache as the
        # memory term does.
        kv_elem_bytes = 1 if kv_quantize == "int8" else 2
        t_net += cfg.n_layers * allgather_cost_s(
            context_len * cfg.d_head * kv_elem_bytes, n_chips
        )
        t_net += 4 * allgather_cost_s(cfg.d_head * kv_elem_bytes, n_chips)
    return t_mem + t_net


def modeled_tp_decode_s(
    cfg: ModelConfig,
    quantize: Optional[str],
    n_chips: int,
    prompt_tokens: int,
    generated_tokens: int,
    kv_quantize: Optional[str] = None,
    sustained_gbps: Optional[float] = None,
) -> float:
    """Modelled decode-loop seconds for a whole generation.

    KV traffic grows linearly over the loop, so the mid-loop context
    (prompt + half the generated tokens) gives the exact sum of the
    linear per-step model in closed form.
    """
    if generated_tokens <= 0:
        return 0.0
    mid_context = prompt_tokens + generated_tokens / 2
    return generated_tokens * modeled_tp_decode_step_s(
        cfg,
        quantize,
        n_chips,
        int(mid_context),
        kv_quantize=kv_quantize,
        sustained_gbps=sustained_gbps,
    )
