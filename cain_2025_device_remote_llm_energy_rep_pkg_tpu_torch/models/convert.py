"""HuggingFace checkpoint -> the port's parameter tree.

The counterpart of the JAX package's ``models/convert.py``: a
``transformers`` causal-LM state dict of any study family (llama3.1,
mistral, qwen2, gemma, phi3) becomes the stacked ``[L, ...]`` tree that
``models/transformer.py`` runs. Both sides rotate RoPE by halves and keep
gemma's zero-centred norm gain as HF stores it, so conversion is transpose
and stack: HF ``nn.Linear`` stores [out, in], the port's weights are
[in, out]; Phi-3's fused ``qkv_proj`` and ``gate_up_proj`` are split.

:func:`load_hf_pretrained` reads a local checkpoint directory's
``*.safetensors`` files (one, or the shards that
``model.safetensors.index.json`` lists) through the port's own reader
(``engine/checkpoint.py``), one tensor at a time, each stacked leaf cast
straight to the target dtype: no ``transformers`` and no whole f32 copy
of the model. Only :func:`hf_config_for` imports ``transformers``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Mapping

import torch

from .config import ModelConfig

Params = Dict[str, Any]
LAYER_LEAVES = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
    "router", "bq", "bk", "bv",
)


def family_of(cfg: ModelConfig) -> str:
    """The family key: the registry name before ``:`` (``llama3.1:8b`` ->
    ``llama3.1``)."""
    return cfg.name.split(":", 1)[0].split("-tiny")[0]


def _layer_tensors(has: Callable[[str], bool], get: Callable[[str], torch.Tensor],
                   cfg: ModelConfig, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves in the port's [in, out] layout."""
    p = f"model.layers.{i}"
    q_dim, kv_dim = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    out = {
        "attn_norm": get(f"{p}.input_layernorm.weight"),
        "mlp_norm": get(f"{p}.post_attention_layernorm.weight"),
    }
    if has(f"{p}.self_attn.qkv_proj.weight"):  # phi3, fused
        qkv = get(f"{p}.self_attn.qkv_proj.weight")  # [q + 2 kv, D]
        out["wq"], out["wk"], out["wv"] = (
            qkv[:q_dim].T, qkv[q_dim : q_dim + kv_dim].T, qkv[q_dim + kv_dim :].T
        )
    else:
        for leaf, proj in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
            out[leaf] = get(f"{p}.self_attn.{proj}.weight").T
    out["wo"] = get(f"{p}.self_attn.o_proj.weight").T
    if cfg.qkv_bias:
        for leaf, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            out[leaf] = get(f"{p}.self_attn.{proj}.bias")
    if cfg.n_experts:  # mixtral: experts stack to [E, D, F] / [E, F, D]
        moe = f"{p}.block_sparse_moe"
        out["router"] = get(f"{moe}.gate.weight").T
        for leaf, w in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            out[leaf] = torch.stack(
                [get(f"{moe}.experts.{e}.{w}.weight").T for e in range(cfg.n_experts)]
            )
    elif has(f"{p}.mlp.gate_up_proj.weight"):  # phi3, fused
        gate_up = get(f"{p}.mlp.gate_up_proj.weight")  # [2F, D]
        out["w_gate"], out["w_up"] = gate_up[: cfg.d_ff].T, gate_up[cfg.d_ff :].T
        out["w_down"] = get(f"{p}.mlp.down_proj.weight").T
    else:
        for leaf, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            out[leaf] = get(f"{p}.mlp.{proj}.weight").T
    return out


def _convert(has, get, cfg: ModelConfig, dtype: torch.dtype, post=None) -> Params:
    """The tree from a name test and a tensor reader; every leaf is
    stacked straight into a tensor of ``dtype``, then passed through
    ``post(name, leaf)`` one leaf at a time (a quantizer frees each
    full-precision leaf before the next)."""
    params: Params = {
        "embed": get("model.embed_tokens.weight").to(dtype),
        "final_norm": get("model.norm.weight").to(dtype),
    }
    for i in range(cfg.n_layers):
        for name, t in _layer_tensors(has, get, cfg, i).items():
            if name not in params:
                params[name] = torch.empty((cfg.n_layers, *t.shape), dtype=dtype)
            params[name][i] = t
    if not cfg.tie_embeddings:
        params["lm_head"] = get("lm_head.weight").T.to(dtype).contiguous()
    out: Params = {}
    for name in ("embed", "final_norm", *LAYER_LEAVES, "lm_head"):
        if name in params:
            leaf = params.pop(name)
            out[name] = leaf if post is None else post(name, leaf)
    return out


def convert_hf_state_dict(
    state_dict: Mapping[str, Any], cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
) -> Params:
    """Map a HF causal-LM state dict onto the port's parameter tree
    (llama-style names, as mistral, qwen2 and gemma use, and phi3's fused
    projections) on the CPU, in ``dtype``."""

    def get(key: str) -> torch.Tensor:
        if key not in state_dict:
            raise KeyError(
                f"{cfg.name}: missing {key!r} in state dict "
                f"(have {len(state_dict)} keys, e.g. {sorted(state_dict)[:3]})"
            )
        return torch.as_tensor(state_dict[key]).detach().cpu()

    return _convert(state_dict.__contains__, get, cfg, dtype)


def hf_config_for(cfg: ModelConfig):
    """The matching ``transformers`` config of a registry entry (to build
    parity-test models and to write test checkpoints)."""
    family = family_of(cfg)
    common = dict(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        intermediate_size=cfg.d_ff,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=cfg.tie_embeddings,
        max_position_embeddings=cfg.max_seq_len,
    )
    if family.startswith("llama"):
        from transformers import LlamaConfig

        return LlamaConfig(head_dim=cfg.d_head, attention_bias=cfg.qkv_bias, **common)
    if family == "mistral":
        from transformers import MistralConfig

        return MistralConfig(head_dim=cfg.d_head, **common)
    if family == "mixtral":
        from transformers import MixtralConfig

        return MixtralConfig(
            head_dim=cfg.d_head, num_local_experts=cfg.n_experts,
            num_experts_per_tok=cfg.top_k_experts, **common,
        )
    if family == "qwen2":
        from transformers import Qwen2Config

        return Qwen2Config(**common)
    if family == "gemma":
        from transformers import GemmaConfig

        return GemmaConfig(head_dim=cfg.d_head, hidden_activation="gelu_pytorch_tanh", **common)
    if family == "phi3":
        from transformers import Phi3Config

        # Phi3Config's default pad_token_id (32000) exceeds small test
        # vocabularies; padding does not touch forward values.
        return Phi3Config(pad_token_id=0, **common)
    raise KeyError(f"no HF config mapping for family {family!r} ({cfg.name})")


def _checkpoint_files(path) -> "list[Path]":
    """The safetensors files of a local checkpoint directory: the shards
    ``model.safetensors.index.json`` lists, else every ``*.safetensors``."""
    path = Path(path)
    index = path / "model.safetensors.index.json"
    if index.exists():
        shards = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        return [path / s for s in shards]
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"{path}: no *.safetensors checkpoint files")
    return files


def load_hf_pretrained(path, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16, post=None) -> Params:
    """Load and convert a local HF checkpoint directory on the CPU (no
    network: ``path`` is on disk); ``post(name, leaf)`` as in
    :func:`_convert` (the engine quantizes there). A tied checkpoint has
    no ``lm_head.weight`` and none is asked for."""
    from ..engine.checkpoint import SafetensorsFile

    where: Dict[str, SafetensorsFile] = {}
    for f in map(SafetensorsFile, _checkpoint_files(path)):
        for key in f.keys():
            where[key] = f

    def get(key: str) -> torch.Tensor:
        if key not in where:
            raise KeyError(f"{cfg.name}: missing {key!r} in {path} (have {len(where)} tensors)")
        return where[key].get(key)

    return _convert(where.__contains__, get, cfg, dtype, post)
