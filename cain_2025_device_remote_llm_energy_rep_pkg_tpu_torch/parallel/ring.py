"""Ring attention: causal self-attention with the sequence split over ``sp``.

Counterpart of the JAX package's ``parallel/ring.py``, in plain torch with
one controller: each of the ``n`` shards holds an S/n token slice of Q, K
and V on its mesh device; the K/V blocks travel around the ring (the
JAX package's ``ppermute``; here a ``.to`` the next shard's device), and
every shard folds each visiting block into an online-softmax
accumulator, so a shard's memory stays O(S/n).

Causality holds at block granularity: a shard attends the visiting blocks
that precede its own slice, with an exact triangular mask on its own
block, so the result matches single-device causal attention up to f32
reduction order. No engine path runs it yet (long-context prefill would).
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from .mesh import Mesh


def _block_attend(
    q: torch.Tensor,  # [B,Sq,Hkv,G,D] f32
    k: torch.Tensor,  # [B,Sk,Hkv,D] f32
    v: torch.Tensor,  # [B,Sk,Hkv,D] f32
    mask: torch.Tensor,  # [Sq,Sk] bool (True = attend)
    m: torch.Tensor,  # [B,Hkv,G,Sq,1]
    l: torch.Tensor,  # [B,Hkv,G,Sq,1]
    acc: torch.Tensor,  # [B,Hkv,G,Sq,D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) * scale
    scores = torch.where(mask[None, None, None], scores, float("-inf"))
    m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
    # a fully masked block keeps m at -inf; exp(-inf - -inf) would be NaN
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    alpha = torch.exp(torch.where(torch.isneginf(m), float("-inf"), m - m_safe))
    p = torch.exp(scores - m_safe)
    l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p, v)
    return m_new, l_new, acc_new


def ring_attention(
    q: List[torch.Tensor],  # per shard [B, S/n, Hq, D], on its device
    k: List[torch.Tensor],  # per shard [B, S/n, Hkv, D]
    v: List[torch.Tensor],
) -> List[torch.Tensor]:
    """Causal attention of the shards' slices around the ring; each
    output [B, S/n, Hq, D] on its shard's device, in ``q``'s dtype."""
    n = len(q)
    b, s_loc, hq, d = q[0].shape
    hkv = k[0].shape[2]
    group = hq // hkv
    states = []
    for i in range(n):
        dev = q[i].device
        states.append((
            q[i].reshape(b, s_loc, hkv, group, d).to(torch.float32),
            torch.full((b, hkv, group, s_loc, 1), float("-inf"), device=dev),
            torch.zeros((b, hkv, group, s_loc, 1), device=dev),
            torch.zeros((b, hkv, group, s_loc, d), device=dev),
        ))
    diag = torch.tril(torch.ones((s_loc, s_loc), dtype=torch.bool))
    blocks = list(zip(k, v))  # blocks[i]: the K/V block shard i holds now
    for step in range(n):
        for i in range(n):
            src = (i - step) % n  # the ring position the visiting block came from
            qg, m, l, acc = states[i]
            dev = qg.device
            mask = diag.to(dev) if src == i else torch.full((s_loc, s_loc), src < i, device=dev)
            kb, vb = blocks[i]
            states[i] = (qg, *_block_attend(
                qg, kb.to(torch.float32), vb.to(torch.float32), mask, m, l, acc
            ))
        # every shard passes its block to the next: shard i + 1 gets i's
        blocks = [
            (blocks[i - 1][0].to(q[i].device), blocks[i - 1][1].to(q[i].device))
            for i in range(n)
        ]
    out = []
    for i, (_, _, l, acc) in enumerate(states):
        o = acc / torch.clamp_min(l, 1e-30)  # [B,Hkv,G,Sq,D] -> [B,Sq,Hq,D]
        out.append(o.permute(0, 3, 1, 2, 4).reshape(b, s_loc, hq, d).to(q[i].dtype))
    return out


def make_ring_attention(mesh: Mesh, axis_name: str = "sp") -> Callable[..., torch.Tensor]:
    """``ring_attention`` over ``mesh``'s ``axis_name`` shards: takes and
    returns whole [B, S, H, D] tensors, the sequence split over the axis
    (each slice on its shard's device), the output gathered on the first."""
    n = mesh.axis(axis_name)
    devices = [mesh.device_at(**{axis_name: i}) for i in range(n)]

    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if q.shape[1] % n:
            raise ValueError(f"sequence {q.shape[1]} does not split over {n} {axis_name} shards")

        def split(x):
            return [c.to(dev) for c, dev in zip(torch.chunk(x, n, dim=1), devices)]

        parts = ring_attention(split(q), split(k), split(v))
        return torch.cat([p.to(devices[0]) for p in parts], dim=1)

    return run
