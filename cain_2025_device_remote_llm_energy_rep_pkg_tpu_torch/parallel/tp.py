"""Tensor-, data- and expert-parallel generation over a mesh of shards.

Counterpart of the JAX package's ``parallel/tp.py``. There, a
``TensorParallelEngine`` is a ``JaxEngine`` whose params and caches carry
shardings, and GSPMD inserts the collectives. Here one controller (this
process) drives every shard explicitly: ``TensorParallelEngine`` is a
``TorchEngine`` whose models are :class:`ShardedTransformer`s, and the
engine, its stepped sessions, speculation, the prefix store and the
serving scheduler run unchanged on top.

The sharded forward (:meth:`ShardedParams.forward`) runs one layer at a
time:

1. each attention shard runs its heads' half (``attention_block`` with the
   shard's config, its slice of ``wq/wk/wv/wo`` and its block of the
   folded KV leaves), writing its K/V and running the same kernels as the
   unsharded engine (B1–B8) at the shard's head count;
2. the row-parallel partials of ``wo`` are added;
3. each FFN shard (each tp × ep shard under MoE) runs its MLP half;
4. those partials (``w_down``, or the expert combine over ``ep``) are added;
5. vocabulary-sharded logits are gathered (``logits``); the vocabulary-
   sharded embedding is a masked lookup per shard, then a sum.

Partials are added in a fixed shard order on the mesh's first device,
each reaching it by ``.to(device)`` (a no-op on one device, a peer copy
across GPUs), so the CPU tests and a one-card mesh run the code a
multi-GPU node runs. Under ``dp`` the forward splits its rows into dp
blocks when the batch divides the axis (the JAX package's rule), each
block's FFN and vocabulary shards on that replica's devices.

The KV leaves and the attention shards' weights live on the mesh's first
device (the folded layout of ``sharding.py``: the engine and its sessions
index every cache leaf as one tensor), so on a node of distinct GPUs the
attention halves run there and the FFN and vocabulary shards, most of
the weights, on their own devices.

The JAX engine's placement hooks (``_place_cache``, ``_place_pool``,
``_place_carry``, the int8 cache's placement) have no counterpart: the
engine and its sessions allocate every KV leaf in the folded layout
through ``_kv_dims``, and ``_dp_shards`` gives a session its dp rows.

Unlike the JAX engine, which turns the int4 kernels (B9/B10) and the
int8-cache kernel (B3) off under a mesh because GSPMD cannot partition a
Pallas call, each shard here runs every kernel on its own slice: on
CUDA the port always runs its kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..engine.torch_engine import TorchEngine
from ..models.config import ModelConfig
from ..models.quantize import embed_lookup, maybe_dequant
from ..models.transformer import (
    NON_LAYER_LEAVES,
    Transformer,
    _cache_layer,
    attention_block,
    decode_lengths,
    is_paged_cache,
    logits_for,
    mlp_block,
    moe_chunks,
    moe_combine,
    moe_experts,
    rope_for,
    split_layers,
)
from ..ops.norms import rms_norm
from .mesh import Mesh, MeshSpec, build_mesh
from .sharding import ShardTrees, plan_for, shard_model


def _reduce(parts: List[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The sum of shard partials, in shard order, on ``home``."""
    acc = parts[0].to(home)
    for part in parts[1:]:
        acc = acc + part.to(home)
    return acc


def _layers(tree: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    stacked = {k: v for k, v in tree.items() if k not in NON_LAYER_LEAVES}
    return split_layers(stacked) if stacked else None


def _rows(leaf, b0: int, b1: int):
    """Rows [b0, b1) of a KV leaf of the engine's layout (no copy): a
    contiguous cache or an int8 pair ([L·S, B, ...]), or a paged leaf,
    whose pool keeps every page (pages are global) while its table, side
    caches and row vectors are cut."""
    if is_paged_cache(leaf):
        out = dict(leaf)
        for key in ("table", "write_pos", "prompt_lens"):
            if key in out:
                out[key] = out[key][b0:b1]
        if "side" in out:
            out["side"] = _rows(out["side"], b0, b1)
        return out
    if isinstance(leaf, dict):
        return {k: v[:, b0:b1] for k, v in leaf.items()}
    return leaf[:, b0:b1]


class ShardedParams:
    """A model's params cut over a mesh (``sharding.ShardTrees``), and the
    sharded forward and logits that ``models/transformer.py``'s
    ``forward`` and ``logits_for`` hand non-dict params to."""

    def __init__(self, trees: ShardTrees, mesh: Mesh) -> None:
        self.trees = trees
        self.mesh = mesh
        self.plan = trees.plan
        self.home = mesh.devices[0]
        self.shared_layers = _layers(trees.shared)
        self.attn_layers = {t: _layers(tree) for t, tree in trees.attn.items()}
        self.mlp_layers = {key: _layers(tree) for key, tree in trees.mlp.items()}
        self.mlp_devices = {key: mesh.device_at(dp=key[0], tp=key[1], ep=key[2]) for key in trees.mlp}
        self.vocab_devices = {key: mesh.device_at(dp=key[0], tp=key[1]) for key in trees.vocab}

    @property
    def dtype(self) -> torch.dtype:
        return self.trees.shared["final_norm"].dtype

    # -- the sharded forward ----------------------------------------------------
    def forward(self, cfg: ModelConfig, tokens, offset, k_cache, v_cache, decode_attention=None, prefill_attention=None):
        """``models.transformer.forward`` over the shards: hidden [B,S,D]
        on the mesh's first device; the caches are written in place."""
        for leaf in (k_cache, v_cache):
            if is_paged_cache(leaf) and ("side" not in leaf or "layer" in leaf):
                raise NotImplementedError(
                    "TP paged rule covers the per-layer stacked parts path only"
                )
        b = tokens.shape[0]
        dp = self.plan.dp
        if dp == 1 or b % dp:
            x = self._forward_rows(0, cfg, tokens, offset, k_cache, v_cache, decode_attention, prefill_attention)
            return x, k_cache, v_cache
        w = b // dp
        outs = []
        for d in range(dp):
            b0, b1 = d * w, (d + 1) * w
            off = offset[b0:b1] if isinstance(offset, torch.Tensor) else offset
            outs.append(self._forward_rows(
                d, cfg, tokens[b0:b1], off, _rows(k_cache, b0, b1), _rows(v_cache, b0, b1),
                decode_attention, prefill_attention,
            ))
        return torch.cat(outs), k_cache, v_cache

    def _forward_rows(self, d, cfg, tokens, offset, k_cache, v_cache, decode_attention, prefill_attention):
        plan, home = self.plan, self.home
        n_layers = cfg.n_layers
        b, s = tokens.shape
        x = self._embed(d, cfg, tokens)
        cos, sin = rope_for(cfg, b, s, offset, home)
        lengths = decode_lengths(b, s, offset, k_cache, decode_attention, home)
        scfg = plan.shard_cfg
        for i in range(n_layers):
            shared = self.shared_layers[i]
            h = rms_norm(x, shared["attn_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)
            parts = [
                attention_block(
                    scfg, h, self.attn_layers[t][i],
                    _cache_layer(k_cache, t * n_layers + i), _cache_layer(v_cache, t * n_layers + i),
                    offset, cos, sin, decode_attention, prefill_attention, lengths,
                )
                for t in range(plan.attn_tp)
            ]
            x = x + _reduce(parts, home)
            h = rms_norm(x, shared["mlp_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)
            x = x + self._mlp(d, cfg, h, i)
        return rms_norm(x, self.trees.shared["final_norm"], cfg.norm_eps, gemma_style=cfg.gemma_norm)

    def _embed(self, d: int, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding: each vocabulary shard looks up the tokens in its
        range (others read row 0, masked to zero), and the partials add
        up to the full lookup exactly (one nonzero term a token)."""
        plan, home = self.plan, self.home
        parts = []
        for t in range(plan.vocab_tp):
            dev = self.vocab_devices[(d, t)]
            tk = tokens.to(dev)
            if plan.vocab_tp == 1:
                parts.append(embed_lookup(self.trees.vocab[(d, t)]["embed"], tk, self.dtype))
                continue
            v0, v1 = plan.vocab_range(t)
            local = tk - v0
            valid = (local >= 0) & (local < v1 - v0)
            part = embed_lookup(self.trees.vocab[(d, t)]["embed"], torch.where(valid, local, 0), self.dtype)
            parts.append(part * valid[..., None].to(part.dtype))
        x = _reduce(parts, home)
        if cfg.gemma_norm:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def _mlp(self, d: int, cfg: ModelConfig, h: torch.Tensor, i: int) -> torch.Tensor:
        plan, home = self.plan, self.home
        keys = [(d, t, e) for t in range(plan.f_tp) for e in range(plan.e_ep)]
        if not cfg.n_experts:
            return _reduce(
                [mlp_block(cfg, h.to(self.mlp_devices[k]), self.mlp_layers[k][i]) for k in keys], home
            )
        # MoE: routing once (the router is one copy), in the unsharded
        # path's token chunks; each tp × ep shard's experts and columns on
        # every token of a chunk, the partials added.
        b, s, dm = h.shape
        weights = {
            k: [maybe_dequant(self.mlp_layers[k][i][n], h.dtype) for n in ("w_gate", "w_up", "w_down")]
            for k in keys
        }
        x = h.reshape(b * s, dm)
        out = torch.empty_like(x)
        chunks = moe_chunks(cfg, b * s, h.element_size())
        for start in chunks:
            xc = x[start : start + chunks.step]
            combine = moe_combine(cfg, xc, self.shared_layers[i]["router"])
            parts = []
            for k in keys:
                e0, e1 = plan.experts(k[2])
                dev = self.mlp_devices[k]
                parts.append(moe_experts(cfg, xc.to(dev), combine[:, e0:e1].to(dev), *weights[k]))
            out[start : start + xc.shape[0]] = _reduce(parts, home)
        return out.reshape(b, s, dm)

    def logits(self, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
        """``models.transformer.logits_for`` over the vocabulary shards of
        dp replica 0, gathered in vocabulary order on the first device."""
        parts = [
            logits_for(self.trees.vocab[(0, t)], cfg, hidden.to(self.vocab_devices[(0, t)]))
            for t in range(self.plan.vocab_tp)
        ]
        if len(parts) == 1:
            return parts[0].to(self.home)
        return torch.cat([p.to(self.home) for p in parts], dim=-1)


@dataclasses.dataclass
class ShardedTransformer(Transformer):
    """A ``Transformer`` whose params are :class:`ShardedParams`: its
    caches come in the folded layout (``sharding.py``)."""

    def __post_init__(self) -> None:
        self.layers = None  # the sharded params keep their own layer views

    @property
    def device(self) -> torch.device:
        return self.params.home

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16):
        plan = self.params.plan
        shape = (self.cfg.n_layers * plan.attn_tp, batch, plan.hkv, max_len, self.cfg.d_head)
        return (
            torch.zeros(shape, dtype=dtype, device=self.device),
            torch.zeros(shape, dtype=dtype, device=self.device),
        )


class TensorParallelEngine(TorchEngine):
    """``TorchEngine`` over a mesh: each model's params cut by
    ``sharding.shard_model`` and run by the sharded forward; the caches,
    page pools and side caches in the folded layout; a stepped session's
    rows over ``dp`` (``PagePool(dp_shards=)``, pages of a row in its
    shard's range). The mesh defaults to every visible GPU on ``tp``."""

    def __init__(self, mesh: Optional[Mesh] = None, **kwargs) -> None:
        self.mesh = mesh if mesh is not None else build_mesh(MeshSpec.tp_only())
        device = kwargs.pop("device", None)
        if device is not None and torch.device(device) != self.mesh.devices[0]:
            raise ValueError(
                f"device {device} is not the mesh's first device {self.mesh.devices[0]}"
            )
        super().__init__(device=self.mesh.devices[0], **kwargs)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def _shard(self, model: str) -> None:
        tf = self._models[model]
        if isinstance(tf, ShardedTransformer):
            return
        trees = shard_model(tf.params, tf.cfg, self.mesh)
        self._models[model] = ShardedTransformer(cfg=tf.cfg, params=ShardedParams(trees, self.mesh))
        del tf, trees
        self._sync()

    def load_model(self, model: str) -> None:
        super().load_model(model)
        self._shard(model)

    def install_model(self, model: str, cfg: ModelConfig, params: Dict[str, Any]) -> None:
        super().install_model(model, cfg, params)
        self._shard(model)

    def _kv_dims(self, cfg: ModelConfig) -> Tuple[int, int]:
        plan = plan_for(cfg, self.mesh)
        return cfg.n_layers * plan.attn_tp, plan.hkv

    def _dp_shards(self) -> int:
        """The mesh's ``dp`` extent: stepped sessions split their rows and
        their page pool into this many ranges."""
        return self.mesh.axis("dp")

    def mesh_info(self) -> Optional[Dict]:
        return {
            "devices": self.mesh.size,
            "axes": {k: int(v) for k, v in self.mesh.shape.items()},
            "platform": "gpu" if self.mesh.devices[0].type == "cuda" else self.mesh.devices[0].type,
        }
