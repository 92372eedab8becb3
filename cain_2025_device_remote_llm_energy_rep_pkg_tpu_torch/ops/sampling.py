"""Token sampling: greedy, temperature, top-k, top-p, repeat penalty.

Counterpart of the JAX package's ``ops/sampling.py``, in llama.cpp's
sampler order: penalties → top-k → top-p (on the unscaled logits) →
temperature. Greedy is ``argmax`` (first index on ties); sampling draws
with ``torch.multinomial`` from the caller's ``torch.Generator``, so the
two packages agree on greedy tokens exactly and on sampled tokens in
distribution only (their random streams differ).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def apply_repeat_penalty(
    logits: torch.Tensor, presence: torch.Tensor, penalty: float
) -> torch.Tensor:
    """Discount tokens already emitted (llama.cpp/Ollama semantics).

    ``presence`` is a bool mask [..., vocab] of token ids seen so far.
    Positive logits divide by ``penalty``, negative multiply — so
    penalty > 1 always moves penalised logits down.
    """
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalised, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of probability-sorted
    tokens whose cumulative mass reaches ``top_p``; mask the rest to -inf.
    Always keeps at least the argmax."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum_excl = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    kept = cum_excl < top_p
    threshold = torch.amin(
        torch.where(kept, sorted_probs, float("inf")), dim=-1, keepdim=True
    )
    return torch.where(probs >= threshold, logits, float("-inf"))


def modified_probs(
    logits: torch.Tensor,
    temperature: "float | torch.Tensor",
    top_k: int = 0,
    top_p: "Optional[float | torch.Tensor]" = None,
) -> torch.Tensor:
    """The distribution :func:`sample_token` draws from, as probabilities
    [..., vocab]: top-k mask, nucleus filter on the unscaled logits, then
    temperature, softmaxed. ``temperature`` and ``top_p`` may be tensors
    shaped to broadcast against ``logits[..., :1]``; temperature is
    clamped at 1e-6 as the sampler does."""
    logits = logits.to(torch.float32)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None:
        logits = top_p_filter(logits, top_p)
    if isinstance(temperature, torch.Tensor):
        safe_t = torch.clamp_min(temperature.to(torch.float32), 1e-6)
    else:
        safe_t = max(float(temperature), 1e-6)
    return torch.softmax(logits / safe_t, dim=-1)


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float,
    top_k: int = 0,
    top_p: Optional[float] = None,
    presence: Optional[torch.Tensor] = None,
    repeat_penalty: Optional[float] = None,
) -> torch.Tensor:
    """Next token ids (int64) from ``logits`` [..., vocab].

    ``temperature`` < 1e-6 means greedy. ``top_k`` 0 disables; ``top_p``
    and ``repeat_penalty`` (with its ``presence`` mask) disable when None.
    """
    logits = logits.to(torch.float32)
    if repeat_penalty is not None and presence is not None:
        logits = apply_repeat_penalty(logits, presence, repeat_penalty)
    if temperature < 1e-6:
        return torch.argmax(logits, dim=-1)
    probs = modified_probs(logits, temperature, top_k, top_p)
    flat = probs.reshape(-1, probs.shape[-1])
    drawn = torch.multinomial(flat, 1, generator=generator)
    return drawn.reshape(probs.shape[:-1])


def sample_token_per_row(
    logits: torch.Tensor,  # [B, vocab]
    generators: Sequence[Optional[torch.Generator]],  # one stream per row
    temperature: Sequence[float],  # [B]
    top_k: int = 0,
    top_p: Optional[Sequence[float]] = None,  # [B]; >= 1.0 disables a row's
    presence: Optional[torch.Tensor] = None,  # [B, vocab] bool
    repeat_penalty: Optional[Sequence[float]] = None,  # [B]; 1.0 disables
) -> torch.Tensor:
    """Row-independent :func:`sample_token`: each row has its own
    generator and knobs (``top_k`` is shared). A row that samples or
    penalises calls ``sample_token`` on ``logits[b:b+1]`` with exactly the
    arguments a solo request passes, so it consumes its generator as the
    solo ``generate`` does and draws the same token from the same logits.
    The other rows are greedy and share one ``argmax``. Knobs are host
    values, so choosing a row's path needs no device sync."""
    out = torch.argmax(logits.to(torch.float32), dim=-1)
    for b, t in enumerate(temperature):
        tp = top_p[b] if top_p is not None and top_p[b] < 1.0 else None
        rp = (
            repeat_penalty[b]
            if repeat_penalty is not None and repeat_penalty[b] != 1.0
            else None
        )
        if t < 1e-6 and rp is None:
            continue
        out[b] = sample_token(
            logits[b : b + 1], generators[b], t, top_k, tp,
            None if presence is None else presence[b : b + 1], rp,
        )[0]
    return out
