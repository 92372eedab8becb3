"""Sharded training step (dp × tp) for the transformer.

Counterpart of the JAX package's ``parallel/train.py``: next-token
cross-entropy and Adam, the params cut over a mesh by ``sharding.py`` and
the batch's rows over ``dp``. The JAX step lets GSPMD turn ``dp`` into
gradient psums and ``tp`` into Megatron collectives; here one controller
runs the sharded forward of ``parallel/tp.py`` (``ShardedParams``) under
autograd, and the gradients come back through its ``.to(device)``
partials (a no-op on one device, a peer copy across GPUs).

What the explicit shards add is copies: a leaf that several shards hold
whole (a dp replica on another device, or the KV head that
``sharding.py`` copies to each tp shard whose queries read it). The step
sums a copy group's gradients in a fixed order onto its first tensor,
runs Adam on that tensor alone, and writes the result into the others, so
the copies never drift apart. A dp replica that shares replica 0's tensor
on one device is one tensor and is counted once. Adam works element by
element, so Adam on the shards is Adam on the whole leaf.

Training runs the plain attention under autograd, as the JAX step runs XLA
(its loss passes ``forward`` no attention callables): there is no
backward kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.config import ModelConfig
from ..models.transformer import forward, logits_for
from .mesh import Mesh
from .sharding import _EXPERT_LEAVES, _LEAF_RULES, ShardPlan, ShardTrees, shard_model

Params = Dict[str, Any]


def next_token_loss(params, cfg: ModelConfig, tokens: torch.Tensor, k0, v0) -> torch.Tensor:
    """Mean cross-entropy of predicting tokens[:, 1:] from tokens[:, :-1]
    (``params``: a dict of whole leaves, or ``ShardedParams``). The zero
    caches ``k0``/``v0`` hold S - 1 positions, so the cache path is pure
    causal attention; their dtype rounds K/V as the JAX step's does."""
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    hidden, _, _ = forward(params, cfg, inputs, 0, k0, v0)
    logits = logits_for(params, cfg, hidden)  # [B, S-1, V] f32
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].to(device=logp.device, dtype=torch.long))[..., 0]
    return -torch.mean(ll)


def as_tokens(tokens, device) -> torch.Tensor:
    """A token batch (a tensor, or anything numpy reads) as int64 on
    ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
    return tokens.to(device=device, dtype=torch.long)


def zero_caches(params, cfg: ModelConfig, batch: int, length: int, dtype: torch.dtype):
    """Zero K/V caches of ``length`` positions in the layout ``forward``
    takes for ``params``: ``[L, B, Hkv, T, D]``, or a sharded model's
    folded ``[L·tp, B, Hkv/tp, T, D]`` (``sharding.py``)."""
    if isinstance(params, dict):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, length, cfg.d_head)
        device = params["final_norm"].device
    else:
        plan = params.plan
        shape = (cfg.n_layers * plan.attn_tp, batch, plan.hkv, length, cfg.d_head)
        device = params.home
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class AdamState:
    """``optax.adam``'s update (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
    through ``torch.optim.Adam``, which computes the same
    ``lr · m̂ / (√v̂ + eps)``, over groups of tensors that are copies of
    one another: the groups' gradients are summed in group order onto the
    first tensor (a copy that received none adds nothing; a group that
    received none steps on zeros, as optax would), Adam steps the first
    tensors, and each result is written into the group's other copies."""

    def __init__(self, groups: Sequence[Sequence[torch.Tensor]], learning_rate: float) -> None:
        self.groups = [list(g) for g in groups]
        for group in self.groups:
            for t in group:
                t.requires_grad_(True)
        self.optimizer = torch.optim.Adam(
            [g[0] for g in self.groups], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )

    def zero_grad(self) -> None:
        for group in self.groups:
            for t in group:
                t.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for group in self.groups:
            head = group[0]
            total = None
            for t in group:
                if t.grad is not None:
                    g = t.grad.to(head.device)
                    total = g if total is None else total + g
            head.grad = torch.zeros_like(head) if total is None else total
            for t in group[1:]:
                t.grad = None
        self.optimizer.step()
        for group in self.groups:
            for t in group[1:]:
                t.copy_(group[0])


def _region(plan: ShardPlan, name: str, t: int, e: int) -> Tuple:
    """Which part of the whole leaf ``name`` the shard (t, e) holds: the
    key that makes two shard tensors copies of one another."""
    group, _, unit = _LEAF_RULES[name]
    cut = plan._range(unit, t) if plan.shards_of(group) > 1 else None
    experts = plan.experts(e) if plan.cfg.n_experts and name in _EXPERT_LEAVES and plan.e_ep > 1 else None
    return (name, cut, experts)


def copy_groups(trees: ShardTrees) -> List[List[torch.Tensor]]:
    """Every distinct tensor of a sharded tree, grouped with its copies
    (the same region of the same leaf), in a fixed order: the shared
    leaves, the attention shards, the FFN shards by (dp, tp, ep), the
    vocabulary shards by (dp, tp)."""
    plan = trees.plan
    groups: Dict[Tuple, List[torch.Tensor]] = {}

    def add(key, leaf) -> None:
        if isinstance(leaf, dict):
            raise ValueError(f"{key[0]}: a quantized leaf cannot be trained")
        group = groups.setdefault(key, [])
        if all(leaf is not other for other in group):
            group.append(leaf)

    for name, leaf in trees.shared.items():
        add((name,), leaf)
    for t, tree in sorted(trees.attn.items()):
        for name, leaf in tree.items():
            add(_region(plan, name, t, 0), leaf)
    for (_, t, e), tree in sorted(trees.mlp.items()):
        for name, leaf in tree.items():
            add(_region(plan, name, t, e), leaf)
    for (_, t), tree in sorted(trees.vocab.items()):
        for name, leaf in tree.items():
            add(_region(plan, name, t, 0), leaf)
    return list(groups.values())


def gather_params(params, grads: bool = False) -> Params:
    """A sharded model's whole leaves in the JAX layout, on the mesh's
    first device (no copy where a leaf is not cut); with ``grads``, the
    gradients of the last step in the same layout. Where shards hold
    copies, the first is read."""
    trees, home = params.trees, params.home
    plan = trees.plan
    read = (lambda t: t.grad) if grads else (lambda t: t.detach())

    def whole(pieces, axis):
        first: Dict[int, torch.Tensor] = {}
        for start, t in pieces:
            first.setdefault(start, t)
        parts = [read(first[k]).to(home) for k in sorted(first)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)

    def start(name, t):
        cut = _region(plan, name, t, 0)[1]
        return 0 if cut is None else cut[0]

    out: Params = {name: read(leaf).to(home) for name, leaf in trees.shared.items()}
    for name in trees.attn[0]:
        axis = _LEAF_RULES[name][1]
        out[name] = whole([(start(name, t), tree[name]) for t, tree in trees.attn.items()], axis)
    for name in trees.mlp[(0, 0, 0)]:
        axis = _LEAF_RULES[name][1]
        by_expert = [
            whole([(start(name, t), trees.mlp[(0, t, e)][name]) for t in range(plan.f_tp)], axis)
            for e in range(plan.e_ep)
        ]
        out[name] = by_expert[0] if len(by_expert) == 1 else torch.cat(by_expert, dim=1)
    for name in trees.vocab[(0, 0)]:
        axis = _LEAF_RULES[name][1]
        out[name] = whole([(start(name, t), trees.vocab[(0, t)][name]) for t in range(plan.vocab_tp)], axis)
    return out


def make_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    learning_rate: float = 1e-4,
    remat: bool = True,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step)``.

    ``init_fn(params)`` cuts the params over ``mesh`` (``shard_model``),
    marks every shard tensor trainable and returns ``(sharded_params,
    opt_state)``; it takes ownership of the params it is given, as the JAX
    step donates them: where a shard is a whole leaf already on its
    device, it shares that leaf's storage, which the steps update.
    ``step(params, opt_state, tokens [B, S])`` returns ``(params,
    opt_state, loss)``; afterwards each trainable tensor's ``.grad`` holds
    the step's gradient (``gather_params(params, grads=True)``). The zero
    caches are bf16, as the JAX step's. ``remat`` recomputes the forward
    in backward (``torch.utils.checkpoint``, non-reentrant), standing for
    ``jax.checkpoint``."""
    from .tp import ShardedParams

    def loss_of(sp, tokens):
        b, s = tokens.shape
        k0, v0 = zero_caches(sp, cfg, b, s - 1, torch.bfloat16)
        return next_token_loss(sp, cfg, tokens, k0, v0)

    def init_fn(params: Params):
        trees = shard_model({k: v.detach() for k, v in params.items()}, cfg, mesh)
        opt_state = AdamState(copy_groups(trees), learning_rate)
        return ShardedParams(trees, mesh), opt_state

    def step(params, opt_state: AdamState, tokens):
        tokens = as_tokens(tokens, params.home)
        opt_state.zero_grad()
        # Fresh layer views of the trainable leaves for this pass.
        sp = ShardedParams(params.trees, mesh)
        loss = checkpoint(loss_of, sp, tokens, use_reentrant=False) if remat else loss_of(sp, tokens)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step


def value_and_grad(loss_fn: Callable[[Params], torch.Tensor], params: Params) -> Tuple[torch.Tensor, Params]:
    """``jax.value_and_grad`` for a loss of a dict of whole leaves: the
    loss and each leaf's gradient, computed on detached copies of the
    leaves' handles (no data is copied; ``params`` is left as it was)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)
    }


__all__ = [
    "AdamState",
    "as_tokens",
    "copy_groups",
    "gather_params",
    "make_train_step",
    "next_token_loss",
    "value_and_grad",
    "zero_caches",
]
