"""Sharding rules for the transformer's parameter and cache trees.

Counterpart of the JAX package's ``parallel/sharding.py``. The JAX package
annotates leaves with shardings and lets GSPMD place the collectives; the
port shards explicitly: :func:`shard_model` cuts one param tree into
per-shard trees, and ``parallel/tp.py`` runs each shard's half of a layer
on its own slice and adds the partial sums. What carries over is the
contract (Megatron-style tensor parallelism, experts over ``ep``, rows
over ``dp``), not GSPMD's placement:

  wq/wk/wv  [L, D, H·Dh]   → column slices of whole heads over tp
  wo        [L, H·Dh, D]   → row slices of the same heads (partials summed)
  w_gate/up [L, D, F]      → F over tp ([L, E, D, F]: experts over ep too)
  w_down    [L, F, D]      → F over tp (partials summed over tp and ep)
  embed     [V, D]         → V over tp (masked lookup, partials summed)
  lm_head   [D, V]         → V over tp (logits gathered)
  norms / router / biases of replicated leaves → one copy

**Head-aligned shards.** The JAX package shards ``wk``/``wv`` whenever
``Hkv·Dh`` divides tp (a quarter of a head per device for qwen2:1.5b at
tp 8, which GSPMD reshards). A kernel takes whole heads, so the port's
rule is head-aligned: attention shards over tp when ``Hq % tp == 0``; the
KV heads (and the cache) shard when ``Hkv % tp == 0``; otherwise, when each
shard's query heads all read one KV head (``G % (Hq/tp) == 0``), a shard
keeps that head (a copy, as the JAX package's replicated cache spec
implies); otherwise attention does not shard and runs whole on shard 0.
The FFN and the vocabulary shard where tp divides them, the experts where
ep divides them.

**Caches.** A sharded model's KV leaves (the contiguous cache, the page
pool, the side caches, a draft's cache) keep the engine's layout with
two changes: the head dim holds a shard's KV heads, and the leading
layer axis folds (shard, layer), shard-major, so shard t's cache is the
contiguous block ``[t·L, (t+1)·L)`` of the leaf — every row, page and
position index of the engine and its sessions is unchanged.
:func:`carry_layout` says which carry leaves each shard owns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..models.config import ModelConfig
from ..models.quantize import slice_leaf
from .mesh import Mesh

# leaf -> (group, axis, unit): the group decides which shards hold the
# leaf, the axis is the one cut (negative: from the end), the unit the
# ranges it is cut by.
_LEAF_RULES: Dict[str, Tuple[str, int, str]] = {
    "wq": ("attn", -1, "q_heads"),
    "bq": ("attn", -1, "q_heads"),
    "wk": ("attn", -1, "kv_heads"),
    "bk": ("attn", -1, "kv_heads"),
    "wv": ("attn", -1, "kv_heads"),
    "bv": ("attn", -1, "kv_heads"),
    "wo": ("attn", -2, "q_heads"),
    "w_gate": ("mlp", -1, "ff"),
    "w_up": ("mlp", -1, "ff"),
    "w_down": ("mlp", -2, "ff"),
    "embed": ("vocab", 0, "vocab"),
    "lm_head": ("vocab", -1, "vocab"),
}
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")  # [L, E, in, out] under MoE


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one model cuts over a mesh: shard counts per group and the
    per-shard head counts (see the module docstring)."""

    cfg: ModelConfig
    dp: int
    attn_tp: int  # shards that split attention (tp, or 1); the KV leaves fold as many
    hq: int  # query heads a shard
    hkv: int  # KV heads a shard
    kv_sharded: bool  # each shard its own KV heads (no copies)
    f_tp: int  # FFN shards
    vocab_tp: int  # vocabulary shards
    e_ep: int  # expert shards

    @property
    def shard_cfg(self) -> ModelConfig:
        """The config a shard's attention half runs: its heads only."""
        return dataclasses.replace(self.cfg, n_heads=self.hq, n_kv_heads=self.hkv)

    def q_heads(self, t: int) -> Tuple[int, int]:
        return t * self.hq, (t + 1) * self.hq

    def kv_heads(self, t: int) -> Tuple[int, int]:
        if self.kv_sharded or self.attn_tp == 1:
            return t * self.hkv, (t + 1) * self.hkv
        group = self.cfg.n_heads // self.cfg.n_kv_heads
        first = (t * self.hq) // group
        return first, first + 1

    def _range(self, unit: str, t: int) -> Tuple[int, int]:
        cfg = self.cfg
        if unit == "q_heads":
            a, b = self.q_heads(t)
            return a * cfg.d_head, b * cfg.d_head
        if unit == "kv_heads":
            a, b = self.kv_heads(t)
            return a * cfg.d_head, b * cfg.d_head
        if unit == "ff":
            w = cfg.d_ff // self.f_tp
            return t * w, (t + 1) * w
        w = cfg.vocab_size // self.vocab_tp
        return t * w, (t + 1) * w

    def shards_of(self, group: str) -> int:
        return {"attn": self.attn_tp, "mlp": self.f_tp, "vocab": self.vocab_tp}[group]

    def vocab_range(self, t: int) -> Tuple[int, int]:
        return self._range("vocab", t)

    def experts(self, e: int) -> Tuple[int, int]:
        w = self.cfg.n_experts // self.e_ep
        return e * w, (e + 1) * w


def plan_for(cfg: ModelConfig, mesh: Mesh) -> ShardPlan:
    """The port's head-aligned rule (module docstring) for ``cfg`` on
    ``mesh``."""
    tp, ep, dp = mesh.axis("tp"), mesh.axis("ep"), mesh.axis("dp")
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    group = hq // hkv
    attn_tp, kv_sharded = 1, False
    if tp > 1 and hq % tp == 0:
        if hkv % tp == 0:
            attn_tp, kv_sharded, hq, hkv = tp, True, hq // tp, hkv // tp
        elif group % (hq // tp) == 0:
            attn_tp, hq, hkv = tp, hq // tp, 1
    return ShardPlan(
        cfg=cfg, dp=dp, attn_tp=attn_tp, hq=hq, hkv=hkv, kv_sharded=kv_sharded,
        f_tp=tp if tp > 1 and cfg.d_ff % tp == 0 else 1,
        vocab_tp=tp if tp > 1 and cfg.vocab_size % tp == 0 else 1,
        e_ep=ep if cfg.n_experts and ep > 1 and cfg.n_experts % ep == 0 else 1,
    )


def param_specs(cfg: ModelConfig, mesh: Mesh) -> Dict[str, Tuple[Optional[str], ...]]:
    """Per leaf, the mesh axis each dim is cut over (None: not cut), as
    the JAX package's PartitionSpecs name them. ``"tp"`` on ``wk``/``wv``
    means head-aligned slices: disjoint when ``Hkv % tp == 0``, else each
    shard's copy of the KV head its query heads read."""
    plan = plan_for(cfg, mesh)
    names = [
        "embed", "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
        "w_gate", "w_up", "w_down", "final_norm",
    ]
    if cfg.qkv_bias:
        names += ["bq", "bk", "bv"]
    if cfg.n_experts:
        names.append("router")
    if not cfg.tie_embeddings:
        names.append("lm_head")
    ndim = {"embed": 2, "lm_head": 2, "final_norm": 1, "attn_norm": 2, "mlp_norm": 2,
            "router": 3, "bq": 2, "bk": 2, "bv": 2}
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for name in names:
        n = ndim.get(name, 4 if cfg.n_experts and name in _EXPERT_LEAVES else 3)
        spec = [None] * n
        rule = _LEAF_RULES.get(name)
        if rule is not None and plan.shards_of(rule[0]) > 1:
            spec[rule[1] % n] = "tp"
        if cfg.n_experts and name in _EXPERT_LEAVES and plan.e_ep > 1:
            spec[1] = "ep"
        out[name] = tuple(spec)
    return out


def _shard_leaf(plan: ShardPlan, name: str, leaf: Any, t: int, e: int) -> Any:
    group, axis, unit = _LEAF_RULES[name]
    if plan.cfg.n_experts and name in _EXPERT_LEAVES and plan.e_ep > 1:
        leaf = slice_leaf(leaf, 1, *plan.experts(e))
    if plan.shards_of(group) == 1:
        return leaf
    return slice_leaf(leaf, axis, *plan._range(unit, t))


def _to(leaf: Any, device) -> Any:
    if isinstance(leaf, dict):
        return {k: v.to(device) for k, v in leaf.items()}
    return leaf.to(device)


@dataclasses.dataclass
class ShardTrees:
    """One model's params cut over a mesh: ``shared`` (norms, router:
    one copy on the mesh's first device), ``attn[t]`` (attention shard t,
    beside the caches on the first device), ``mlp[(d, t, e)]`` and
    ``vocab[(d, t)]`` (each on its mesh device; a dp replica on the same
    device as replica 0 holds the same tensors)."""

    plan: ShardPlan
    shared: Dict[str, Any]
    attn: Dict[int, Dict[str, Any]]
    mlp: Dict[Tuple[int, int, int], Dict[str, Any]]
    vocab: Dict[Tuple[int, int], Dict[str, Any]]


def shard_model(params: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> ShardTrees:
    """Cut ``params`` (any leaf form) into per-shard trees by the rules
    above. Each shard's leaves are contiguous copies on its device."""
    plan = plan_for(cfg, mesh)
    home = mesh.devices[0]
    shared = {n: _to(v, home) for n, v in params.items() if n not in _LEAF_RULES}
    attn = {
        t: {
            n: _to(_shard_leaf(plan, n, v, t, 0), home)
            for n, v in params.items() if _LEAF_RULES.get(n, ("",))[0] == "attn"
        }
        for t in range(plan.attn_tp)
    }
    mlp: Dict[Tuple[int, int, int], Dict[str, Any]] = {}
    vocab: Dict[Tuple[int, int], Dict[str, Any]] = {}
    for d in range(plan.dp):
        for t in range(plan.f_tp):
            for e in range(plan.e_ep):
                dev = mesh.device_at(dp=d, tp=t, ep=e)
                src = mlp.get((0, t, e)) if d else None
                mlp[(d, t, e)] = (
                    {n: _to(v, dev) for n, v in src.items()} if src is not None else {
                        n: _to(_shard_leaf(plan, n, v, t, e), dev)
                        for n, v in params.items() if _LEAF_RULES.get(n, ("",))[0] == "mlp"
                    }
                )
        for t in range(plan.vocab_tp):
            dev = mesh.device_at(dp=d, tp=t)
            src = vocab.get((0, t)) if d else None
            vocab[(d, t)] = (
                {n: _to(v, dev) for n, v in src.items()} if src is not None else {
                    n: _to(_shard_leaf(plan, n, v, t, 0), dev)
                    for n, v in params.items() if _LEAF_RULES.get(n, ("",))[0] == "vocab"
                }
            )
    return ShardTrees(plan=plan, shared=shared, attn=attn, mlp=mlp, vocab=vocab)


# carry leaves that hold KV payload in the folded layout (module docstring)
_PAYLOAD_KEYS = ("k_cache", "v_cache", "pool", "side_k", "side_v")
_DRAFT_KEYS = ("draft_k", "draft_v")


def carry_layout(
    cfg: ModelConfig,
    mesh: Mesh,
    carry: Dict[str, Any],
    draft_cfg: Optional[ModelConfig] = None,
    dp_shards: int = 1,
) -> Dict[str, Dict[str, Optional[str]]]:
    """Which part of each stepped-session carry leaf a shard owns (the
    JAX package's ``stepped_carry_shardings``, as ownership): ``"heads"``
    is ``"tp"`` where a KV leaf's folded axis splits over tp (the draft
    cache by the draft model's own heads), ``"rows"`` is ``"dp"`` where
    the session's rows (the pool: its pages) split over dp —
    ``dp_shards`` is the session's engaged dp, 1 when the bucket does not
    divide the axis. Row-control leaves with a leading row dim split over
    dp with the rows; everything else is one copy."""
    rows = "dp" if dp_shards > 1 else None
    heads = "tp" if plan_for(cfg, mesh).attn_tp > 1 else None
    draft_heads = "tp" if draft_cfg is not None and plan_for(draft_cfg, mesh).attn_tp > 1 else None
    tok = carry.get("tokens")
    b = int(tok.shape[0]) if tok is not None and getattr(tok, "ndim", 0) else 0
    out: Dict[str, Dict[str, Optional[str]]] = {}
    for key, leaf in carry.items():
        if key in _PAYLOAD_KEYS:
            out[key] = {"heads": heads, "rows": rows}
        elif key in _DRAFT_KEYS:
            out[key] = {"heads": draft_heads, "rows": rows}
        elif rows and getattr(leaf, "ndim", 0) >= 1 and int(leaf.shape[0]) == b:
            out[key] = {"heads": None, "rows": rows}
        else:
            out[key] = {"heads": None, "rows": None}
    return out
