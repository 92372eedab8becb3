"""Pipeline parallelism: a GPipe microbatch schedule over a ``pp`` axis.

Counterpart of the JAX package's ``parallel/pp.py``. Every layer leaf
carries a leading ``[L, …]`` axis, so cutting that axis over the ``pp``
mesh axis is the stage assignment: stage ``i`` holds layers
``[i·L/S, (i+1)·L/S)`` on its mesh device, and the leaves with no layer
axis (``embed``, ``final_norm``, ``lm_head``) are copies, one per stage.

Schedule: GPipe fill-drain over ``M + S - 1`` ticks. At each tick a stage
takes its predecessor's activation of the previous tick by ``.to(device)``
(a no-op on one device, a peer copy across GPUs), runs its layers, and
hands the result on; the last stage keeps each finished microbatch. The
JAX package runs the schedule as one ``lax.scan`` inside ``shard_map``
and computes and masks the fill and drain ticks where a stage holds no
microbatch; this one controller skips them. After the last tick the last
stage projects all M finished microbatches to the vocabulary once and
takes the mean loss. Backward through the schedule is autograd's: the
cotangents flow stage by stage through the ``.to`` hand-offs, and the
gradients of the replicated leaves, partial per stage, are summed over
the stages in stage order, as the JAX package's ``psum`` over ``pp``.

Training attention is the plain causal path over zero caches of exactly
S - 1 slots, in the activations' dtype, as the JAX pipeline tick runs it,
so the pipelined loss matches ``parallel.train.next_token_loss`` up to f32
reduction order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import NON_LAYER_LEAVES, embed_tokens, logits_for, rope_for, run_blocks, split_layers
from ..ops.norms import rms_norm
from .mesh import Mesh
from .train import AdamState, as_tokens

Params = Dict[str, Any]
Stages = List[Params]

# Leaves with no leading [L, …] layer axis — copied to every stage.
REPLICATED_LEAVES = NON_LAYER_LEAVES


def pp_param_specs(cfg: ModelConfig, axis: str = "pp") -> Dict[str, Tuple[Optional[str], ...]]:
    """Per leaf, the mesh axis each dim is cut over (the form of
    ``sharding.param_specs``): the stacked-layer axis over ``axis``."""
    specs: Dict[str, Tuple[Optional[str], ...]] = {
        "embed": (None, None),
        "final_norm": (None,),
        "attn_norm": (axis, None),
        "mlp_norm": (axis, None),
        "wq": (axis, None, None),
        "wk": (axis, None, None),
        "wv": (axis, None, None),
        "wo": (axis, None, None),
    }
    # MoE MLP leaves carry an extra expert axis; the stage (layer) axis is
    # still the leading one either way.
    mlp_nd = 4 if cfg.n_experts else 3
    for k in ("w_gate", "w_up", "w_down"):
        specs[k] = (axis, *([None] * (mlp_nd - 1)))
    if cfg.n_experts:
        specs["router"] = (axis, None, None)
    if cfg.qkv_bias:
        specs.update(bq=(axis, None), bk=(axis, None), bv=(axis, None))
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, None)
    return specs


def _check_stages(cfg: ModelConfig, mesh: Mesh, axis: str) -> int:
    n_stages = mesh.axis(axis)
    if cfg.n_layers % n_stages != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={n_stages}")
    return n_stages


def _stage_devices(mesh: Mesh, axis: str, n_stages: int) -> List[torch.device]:
    return [mesh.device_at(**{axis: i}) for i in range(n_stages)]


def stage_params(params: Params, cfg: ModelConfig, mesh: Mesh, axis: str = "pp", copy: bool = False) -> Stages:
    """One dict per stage: its layers' slice of every layer leaf and the
    replicated leaves, on its mesh device. Without ``copy`` a slice on its
    own device is a view of ``params`` and each stage's replicated leaf is
    a handle of its own on the same storage (so its gradient stays its
    own); with ``copy`` the stages after the first own copies of the
    replicated leaves (the training step writes one update into each)."""
    n_stages = _check_stages(cfg, mesh, axis)
    n_local = cfg.n_layers // n_stages
    stages = []
    for i, dev in enumerate(_stage_devices(mesh, axis, n_stages)):
        stage = {}
        for name, leaf in params.items():
            if isinstance(leaf, dict):
                raise ValueError(f"{name}: the pipeline runs full-precision leaves")
            if name not in REPLICATED_LEAVES:
                stage[name] = leaf[i * n_local : (i + 1) * n_local].detach().to(dev)
                continue
            part = leaf.detach().to(dev)
            stage[name] = part.clone() if copy and i and part.data_ptr() == leaf.data_ptr() else part
        stages.append(stage)
    return stages


def _pp_local_loss_body(cfg: ModelConfig, n_microbatches: int, n_stages: int, axis: str,
                        reduce: bool = True) -> Callable[[Stages, torch.Tensor], List[torch.Tensor]]:
    """The pipeline's loss over ``stages``: one value per stage, on the
    stage's device. The loss lives on the last stage; with ``reduce``
    every stage gets it (the JAX body's ``psum``), without it the other
    stages hold 0 and the grad path differentiates the last stage's value
    alone, so every cotangent reaches the earlier stages through the
    hand-offs exactly once."""

    def local_loss(stages: Stages, tokens: torch.Tensor) -> List[torch.Tensor]:
        m = n_microbatches
        b, s = tokens.shape
        if b % m != 0:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        devices = [stage["final_norm"].device for stage in stages]
        mb = tokens.reshape(m, b // m, s)
        inputs, targets = mb[:, :, :-1], mb[:, :, 1:]
        b_mb, s_in = b // m, s - 1
        dtype = stages[0]["final_norm"].dtype
        layers = [split_layers({k: v for k, v in st.items() if k not in REPLICATED_LEAVES}) for st in stages]
        ropes = [rope_for(cfg, b_mb, s_in, 0, dev) for dev in devices]
        n_local = cfg.n_layers // n_stages
        cache_shape = (n_local, b_mb, cfg.n_kv_heads, s_in, cfg.d_head)

        held: List[Optional[torch.Tensor]] = [None] * n_stages  # each stage's last output
        finished = []
        for tick in range(m + n_stages - 1):
            # Later stages first: stage i reads stage i - 1's previous tick.
            for i in reversed(range(n_stages)):
                j = tick - i  # the microbatch stage i holds at this tick
                if not 0 <= j < m:
                    continue
                dev = devices[i]
                if i == 0:
                    x = embed_tokens(cfg, stages[0]["embed"], inputs[j].to(dev), dtype)
                else:
                    x = held[i - 1].to(dev)
                # Zero caches of exactly S_in slots: the cache path is pure
                # causal attention, the same layer math as every other mode.
                k0 = torch.zeros(cache_shape, dtype=x.dtype, device=dev)
                v0 = torch.zeros(cache_shape, dtype=x.dtype, device=dev)
                x = run_blocks(layers[i], cfg, x, 0, k0, v0, *ropes[i])
                if i == n_stages - 1:
                    finished.append(x)
                else:
                    held[i] = x
        # Project all M finished microbatches to the vocabulary once.
        last = stages[-1]
        h = rms_norm(torch.stack(finished), last["final_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)
        logp = torch.log_softmax(logits_for(last, cfg, h), dim=-1)
        tgt = targets.to(device=logp.device, dtype=torch.long)
        loss = -torch.mean(torch.gather(logp, -1, tgt[..., None])[..., 0])
        if reduce:
            return [loss.to(dev) for dev in devices]
        return [torch.zeros((), device=dev) for dev in devices[:-1]] + [loss]

    return local_loss


def make_pp_loss(cfg: ModelConfig, mesh: Mesh, n_microbatches: int, axis: str = "pp"):
    """Pipelined next-token loss: ``(params, tokens [B, S]) → scalar``;
    ``params`` is a dict of whole leaves or the stages of
    ``make_pp_train_step``'s ``init_fn``. Forward evaluation only: it runs
    under ``torch.no_grad``; use :func:`make_pp_grad` /
    :func:`make_pp_train_step` for gradients."""
    n_stages = _check_stages(cfg, mesh, axis)
    body = _pp_local_loss_body(cfg, n_microbatches, n_stages, axis)

    @torch.no_grad()
    def pp_loss(params, tokens) -> torch.Tensor:
        stages = stage_params(params, cfg, mesh, axis) if isinstance(params, dict) else params
        return body(stages, as_tokens(tokens, stages[0]["final_norm"].device))[0]

    return pp_loss


def make_pp_grad(cfg: ModelConfig, mesh: Mesh, n_microbatches: int, axis: str = "pp"):
    """``(params, tokens) → (loss, grads)`` through the pipeline schedule,
    ``params`` a dict of whole leaves and ``grads`` in the same layout on
    the first stage's device. Layer-leaf grads are stage-local by
    construction (concatenated in stage order); replicated-leaf grads are
    partial per stage and summed in stage order."""
    n_stages = _check_stages(cfg, mesh, axis)
    body = _pp_local_loss_body(cfg, n_microbatches, n_stages, axis, reduce=False)

    def vag(params: Params, tokens) -> Tuple[torch.Tensor, Params]:
        stages = stage_params(params, cfg, mesh, axis)
        for stage in stages:
            for t in stage.values():
                t.requires_grad_(True)
        loss = body(stages, as_tokens(tokens, stages[0]["final_norm"].device))[-1]
        loss.backward()
        home = stages[0]["final_norm"].device
        grads: Params = {}
        for name in params:
            if name not in REPLICATED_LEAVES:
                grads[name] = torch.cat([stage[name].grad.to(home) for stage in stages])
                continue
            total = torch.zeros_like(params[name], device=home)
            for stage in stages:  # a stage that does not read the leaf adds nothing
                if stage[name].grad is not None:
                    total = total + stage[name].grad.to(home)
            grads[name] = total
        return loss.detach().to(home), grads

    return vag


def make_pp_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    n_microbatches: int,
    learning_rate: float = 1e-4,
    axis: str = "pp",
):
    """``(init_fn, step)`` for pipeline-parallel training over ``mesh``, as
    ``parallel.train.make_train_step``'s contract: ``init_fn(params) →
    (stages, opt_state)``, each stage's tensors on its device (it takes
    ownership of ``params``, as the JAX step donates them);
    ``step(stages, opt_state, tokens [B, S]) → (stages, opt_state, loss)``
    with B divisible by ``n_microbatches``. Adam (optax's defaults) runs on
    each layer slice and on stage 0's copy of each replicated leaf, whose
    gradient is the stages' sum; the result is written into the other
    stages' copies."""
    n_stages = _check_stages(cfg, mesh, axis)
    body = _pp_local_loss_body(cfg, n_microbatches, n_stages, axis, reduce=False)

    def init_fn(params: Params) -> Tuple[Stages, AdamState]:
        stages = stage_params(params, cfg, mesh, axis, copy=True)
        groups: List[List[torch.Tensor]] = []
        for name in params:
            if name in REPLICATED_LEAVES:
                groups.append([stage[name] for stage in stages])
            else:
                groups.extend([stage[name]] for stage in stages)
        return stages, AdamState(groups, learning_rate)

    def step(stages: Stages, opt_state: AdamState, tokens):
        opt_state.zero_grad()
        loss = body(stages, as_tokens(tokens, stages[0]["final_norm"].device))[-1]
        loss.backward()
        opt_state.step()
        return stages, opt_state, loss.detach()

    return init_fn, step
