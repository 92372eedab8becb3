"""Energy-attribution bridge: live per-request Joules from the documented
power-coefficient box.

The paper's unit of account is Joules per fetched response; the
framework's energy model (``profilers/nvml.py::GpuEnergyModelProfiler``,
the H100's constants) could only produce that number inside a runner
measurement window — serving traffic got nothing. This module folds the
SAME model (and the SAME per-engine coefficient box, the ``H100_*_BOUNDS``
constants next to the nominal values) into live per-request estimates:

- each :class:`~..engine.backend.GenerationResult` gains
  ``extras["energy_model"]`` with nominal J / J-per-token plus the
  low/high corner of the coefficient box — the per-request twin of the
  ``recompute-energy`` sensitivity band, so a serving
  dashboard shows not just a number but how far the model's uncertainty
  moves it;
- the shared metrics registry gains ``llm_request_*`` energy families
  for the ``/metrics`` scrape.

Everything here is an ESTIMATE (the column name says ``model``, matching
``energy_model_J``'s labelling discipline) and must never fail a
request: callers wrap in try/except, and inputs the model can't price
(zero tokens, missing config) return None. The model's watts are
uncalibrated (``profilers/nvml.py``): NVML's measured Joules are the
study's energy metric wherever the card's counter reads.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

from ..profilers.nvml import (
    GpuEnergyModelProfiler,
    H100_CUDA_CORE_ACTIVE_W_BOUNDS,
    H100_HBM_ACTIVE_W_BOUNDS,
    H100_IDLE_W_BOUNDS,
    H100_TENSOR_ACTIVE_W_BOUNDS,
)
from .metrics import REGISTRY, enabled

# J/token of one device spans ~0.05 (wide batched decode) to ~10+ (a lone
# short request paying the whole idle window).
ENERGY_BUCKETS = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
)

REQUEST_J = REGISTRY.histogram(
    "llm_request_energy_model_joules",
    "Modelled Joules attributed to one served generation",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0),
)
REQUEST_JPT = REGISTRY.histogram(
    "llm_request_joules_per_token",
    "Modelled J/token of one served generation (nominal coefficients)",
    buckets=ENERGY_BUCKETS,
)
REQUEST_JPT_BOUND = REGISTRY.gauge(
    "llm_request_joules_per_token_bound",
    "Last request's modelled J/token at the coefficient-box corner",
    labels=("bound",),
)


def _corner(which: str, n_chips: int) -> GpuEnergyModelProfiler:
    i = 0 if which == "low" else 1
    return GpuEnergyModelProfiler(
        n_chips=n_chips,
        idle_w=H100_IDLE_W_BOUNDS[i],
        tensor_active_w=H100_TENSOR_ACTIVE_W_BOUNDS[i],
        hbm_active_w=H100_HBM_ACTIVE_W_BOUNDS[i],
        cuda_core_active_w=H100_CUDA_CORE_ACTIVE_W_BOUNDS[i],
    )


def estimate_from_stats(
    stats: Dict[str, Any], n_chips: int = 1
) -> Optional[Dict[str, Any]]:
    """Evaluate the energy model at the nominal coefficients and at both
    corners of the documented box. ``stats`` is the
    ``generation_stats`` shape the profiler consumes (flops / bytes /
    vpu_ops / duration_s / generated_tokens)."""
    if not stats or not stats.get("duration_s"):
        return None
    ctx = SimpleNamespace(scratch={"generation_stats": stats})
    nominal = GpuEnergyModelProfiler(n_chips=n_chips).collect(ctx)
    if nominal["energy_model_J"] is None:
        return None
    low = _corner("low", n_chips).collect(ctx)
    high = _corner("high", n_chips).collect(ctx)
    return {
        "J": nominal["energy_model_J"],
        "J_low": low["energy_model_J"],
        "J_high": high["energy_model_J"],
        "J_per_token": nominal["joules_per_token"],
        "J_per_token_low": low["joules_per_token"],
        "J_per_token_high": high["joules_per_token"],
        "power_model_W": nominal["gpu_power_model_W"],
        "util_est": nominal["gpu_util_est"],
    }


def attribute_result(
    cfg,
    result,
    quantize: Optional[str] = None,
    kv_quantize: Optional[str] = None,
    n_chips: int = 1,
) -> Optional[Dict[str, Any]]:
    """Per-request estimate for a SOLO generation: the run-table stats
    function (``generation_stats_from`` — decode-window duration, weight +
    KV stream bytes at mid-context, weight-unpack ops) evaluated live."""
    from ..experiments.llm_energy import generation_stats_from

    stats = generation_stats_from(
        cfg, result, quantize=quantize, kv_quantize=kv_quantize,
        n_chips=n_chips,
    )
    return estimate_from_stats(stats, n_chips=n_chips)


def batch_window_stats(
    cfg,
    results,
    quantize: Optional[str] = None,
    kv_quantize: Optional[str] = None,
    duration_s: float = 0.0,
) -> Optional[Dict[str, Any]]:
    """Energy-model inputs for ONE shared batched decode window.

    Rows in a batch share the weight stream (billed once per step — the
    amortisation batching exists for) while each row streams its own KV
    at its own mid-context; summing per-row solo estimates would instead
    bill the weight stream per row and multiply-count the shared window
    (the same double-count ``decode_s`` documents for wall time)."""
    if not results or duration_s <= 0:
        return None
    from ..utils.memory import (
        decode_kv_stream_bytes,
        decode_vpu_unpack_ops_per_step,
        decode_weight_stream_bytes,
    )

    tokens = sum(r.generated_tokens for r in results)
    if not tokens:
        return None
    steps = max(r.generated_tokens for r in results)
    flops = sum(
        cfg.flops_per_token(r.prompt_tokens + r.generated_tokens)
        * (r.prompt_tokens + r.generated_tokens)
        for r in results
    )
    hbm = decode_weight_stream_bytes(cfg, quantize) * steps + sum(
        decode_kv_stream_bytes(
            cfg,
            int(r.prompt_tokens + r.generated_tokens / 2),
            kv_quantize=kv_quantize,
        )
        * r.generated_tokens
        for r in results
    )
    return {
        "flops": flops,
        "bytes": hbm,
        "vpu_ops": decode_vpu_unpack_ops_per_step(cfg, quantize) * steps,
        "duration_s": duration_s,
        "generated_tokens": tokens,
    }


def slice_window_stats(
    cfg,
    pairs,
    duration_s: float,
    steps: int,
    quantize: Optional[str] = None,
    kv_quantize: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """Energy-model inputs for ONE bounded decode slice of a continuous
    session. ``pairs`` is ``[(ctx_tokens, new_tokens), ...]``
    per live row: ``ctx_tokens`` the row's context length entering the
    slice (prompt + already-generated), ``new_tokens`` what this slice
    emitted for it; ``steps`` the device steps the slice actually ran
    (== max new_tokens for plain decode, the verify-round count under
    speculation).

    Same accounting discipline as :func:`batch_window_stats` — the
    weight stream bills ONCE per step across the shared batch, each row
    streams its own KV at its own slice-mid context — but scoped to one
    slice's marginal work, so per-slice estimates summed over a row's
    lifetime converge to what one whole-window estimate would say."""
    if duration_s <= 0 or steps <= 0:
        return None
    from ..utils.memory import (
        decode_kv_stream_bytes,
        decode_vpu_unpack_ops_per_step,
        decode_weight_stream_bytes,
    )

    tokens = sum(new for _, new in pairs)
    if not tokens:
        return None
    flops = sum(
        cfg.flops_per_token(ctx + new) * new for ctx, new in pairs if new
    )
    hbm = decode_weight_stream_bytes(cfg, quantize) * steps + sum(
        decode_kv_stream_bytes(
            cfg, int(ctx + new / 2), kv_quantize=kv_quantize
        )
        * new
        for ctx, new in pairs
        if new
    )
    return {
        "flops": flops,
        "bytes": hbm,
        "vpu_ops": decode_vpu_unpack_ops_per_step(cfg, quantize) * steps,
        "duration_s": duration_s,
        "generated_tokens": tokens,
    }


def observe_estimate(est: Optional[Dict[str, Any]]) -> None:
    """Record one request's estimate into the shared registry."""
    if est is None or not enabled():
        return
    if est.get("J") is not None:
        REQUEST_J.observe(est["J"])
    if est.get("J_per_token") is not None:
        REQUEST_JPT.observe(est["J_per_token"])
        if est.get("J_per_token_low") is not None:
            REQUEST_JPT_BOUND.labels(bound="low").set(est["J_per_token_low"])
        if est.get("J_per_token_high") is not None:
            REQUEST_JPT_BOUND.labels(bound="high").set(est["J_per_token_high"])


# -- wasted-energy ledger ------------------------------------------------------
# Joules burned on work the caller never benefits from, attributed to a
# CAUSE and surviving retries and preemption: a retried ticket's first
# attempt burned prefill on a replica that died before streaming; a
# recompute-policy resume re-prefills prompt + generated tokens it
# already paid for once; a swap preemption moves KV payload over the
# host link twice. The study's unit of account is Joules per fetched
# response — this ledger is where the Joules that DON'T end up in a
# response go, so fleet J/token can be read honestly next to it.

WASTED_J = REGISTRY.counter(
    "llm_request_wasted_joules_total",
    "Modelled Joules burned on work no response benefits from, by cause "
    "(retry: burned on a replica that died before the ticket's first "
    "streamed token; recompute: a preemption victim's re-prefill of "
    "prompt + generated tokens under --preempt-policy recompute; swap: "
    "KV payload moved device<->host by a swap preemption; escalation: "
    "a small-first model cascade abandoned the small model's answer — "
    "its prefill + generated tokens — and re-ran on the big model; "
    "draft: a cross-model speculative round whose drafted tokens were "
    "ALL rejected — the draft lane's Joules bought nothing)",
    labels=("cause",),
)
WASTED_TOKENS = REGISTRY.counter(
    "llm_request_wasted_tokens_total",
    "Token positions computed more than once (or thrown away), by the "
    "same causes as llm_request_wasted_joules_total (swap moves bytes, "
    "not tokens: it counts 0 here)",
    labels=("cause",),
)

# Fallback J/token when no live attribution exists yet (fresh process,
# fake backends): the geometric center of ENERGY_BUCKETS' working band —
# an order-of-magnitude placeholder the live REQUEST_JPT mean replaces
# the moment real requests have been attributed.
NOMINAL_JPT_FALLBACK = 0.5
# Energy of moving one KV byte device<->host for a swap preemption
# (DMA + DDR write ≈ tens of pJ/byte; nominal, documented as a model).
SWAP_J_PER_BYTE = 1e-9


def live_joules_per_token() -> float:
    """The process's live mean J/token (REQUEST_JPT sum/count), falling
    back to :data:`NOMINAL_JPT_FALLBACK` before any request has been
    attributed — the figure wasted-token charges are priced at."""
    child = REQUEST_JPT._default
    if child.count:
        return child.sum / child.count
    return NOMINAL_JPT_FALLBACK


def charge_wasted(
    cause: str,
    tokens: float = 0.0,
    nbytes: float = 0.0,
    jpt: Optional[float] = None,
) -> float:
    """Charge one waste event to the ledger and return the Joules
    charged (0.0 when telemetry is off — callers stamp the figure into
    ``x_extras.energy`` too, so it must come back). ``tokens`` price at
    ``jpt`` (default: the live process mean), ``nbytes`` at the nominal
    host-link energy; either may be zero."""
    if not enabled():
        return 0.0
    joules = 0.0
    if tokens > 0:
        joules += tokens * (jpt if jpt else live_joules_per_token())
        WASTED_TOKENS.labels(cause=cause).inc(tokens)
    if nbytes > 0:
        joules += nbytes * SWAP_J_PER_BYTE
    if joules > 0:
        WASTED_J.labels(cause=cause).inc(joules)
    return joules
