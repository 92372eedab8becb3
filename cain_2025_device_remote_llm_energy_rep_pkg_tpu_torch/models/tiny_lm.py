"""A trainable tiny language model with real (learned) weights.

Counterpart of the JAX package's ``models/tiny_lm.py``. The study's cell
on real weights needs a run whose generation lengths are content-driven
(EOS fires before the token budget) and whose text is learned, not
random-init noise. Nothing is downloaded, so the port earns its weights
the same way: it trains them with its own sharded train step
(``parallel/train.py``) on an original in-repo corpus built from the
study's topic pool.

The model is byte-level (``models/tokenizer.ByteTokenizer``) and learns
short factual sentences terminated by EOS, so a served generation gives
readable text and stops itself. Its head width is 32, which the port's
attention kernels take natively. Training runs on the card unless the
caller asks for the CPU; checkpoints are safetensors files
(``engine/checkpoint.py``).
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .config import ModelConfig
from .tokenizer import ByteTokenizer

TINY_LM_NAME = "tiny-lm:trained"

_TEMPLATES = (
    "Here is information about {t}. {T} is a widely studied subject.",
    "{T} matters because people want to understand {t}.",
    "A short note on {t}: students often read about {t} first.",
    "{T} appears in many textbooks, and {t} is discussed in class.",
)


def tiny_lm_config(
    d_model: int = 128,
    n_layers: int = 4,
    max_seq_len: int = 512,
) -> ModelConfig:
    tok = ByteTokenizer()
    return ModelConfig(
        name=TINY_LM_NAME,
        vocab_size=tok.vocab_size,
        d_model=d_model,
        n_layers=n_layers,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=4 * d_model,
        tie_embeddings=True,
        max_seq_len=max_seq_len,
    )


def build_corpus(topics: Optional[List[str]] = None) -> List[str]:
    """Original sentences over the study's topic pool
    (``experiments/topics.py``)."""
    if topics is None:
        from ..experiments.topics import TOPICS

        topics = TOPICS
    corpus = []
    for topic, template in zip(topics, itertools.cycle(_TEMPLATES)):
        corpus.append(template.format(t=topic, T=topic[0].upper() + topic[1:]))
    return corpus


def _pack_rows(corpus: List[str], seq_len: int) -> "list[list[int]]":
    """One sentence per row: BOS + bytes + EOS, padded with EOS to
    ``seq_len``: the model learns both the text and that sentences END
    (EOS is an absorbing state), which is what makes served generations
    stop before their token budget."""
    tok = ByteTokenizer()
    rows = []
    for text in corpus:
        ids = tok.encode(text) + [tok.eos_id]
        ids = ids[:seq_len]
        rows.append(ids + [tok.eos_id] * (seq_len - len(ids)))
    return rows


def train_tiny_lm(
    cfg: Optional[ModelConfig] = None,
    corpus: Optional[List[str]] = None,
    steps: int = 400,
    batch: int = 16,
    seq_len: int = 96,
    learning_rate: float = 3e-3,
    seed: int = 0,
    loss_target: float = 0.1,
    log_every: int = 0,
    device=None,
) -> Tuple[Dict, List[float]]:
    """Train the tiny LM with the port's dp × tp train step on a
    one-device mesh. Returns (params, loss history): f32 leaves on
    ``device``; stops early once the mean of the last five losses is below
    ``loss_target``. The init draws from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, and the batches are the JAX package's draw
    (``np.random.default_rng(seed).integers``). ``device`` None means the
    card; without one that is an error, never a move to the CPU."""
    import numpy as np
    import torch

    from ..parallel.mesh import MeshSpec, build_mesh
    from ..parallel.train import gather_params, make_train_step
    from .transformer import init_params

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "train_tiny_lm trains on a CUDA device and none is available; "
                "pass device='cpu' explicitly to train on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if cfg is None:
        cfg = tiny_lm_config()
    rows = _pack_rows(corpus or build_corpus(), seq_len)
    data = np.asarray(rows, dtype=np.int32)

    mesh = build_mesh(MeshSpec.dp_tp(1, 1), devices=[device])
    init_fn, step = make_train_step(cfg, mesh, learning_rate=learning_rate, remat=False)
    generator = torch.Generator(device=device).manual_seed(seed)
    params, opt_state = init_fn(init_params(cfg, generator, torch.float32))

    rng = np.random.default_rng(seed)
    losses: List[float] = []
    for i in range(steps):
        idx = rng.integers(0, len(data), size=batch)
        params, opt_state, loss = step(params, opt_state, data[idx])
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            from ..runner import term

            term.log(f"tiny-lm step {i + 1}/{steps}: loss {losses[-1]:.4f}")
        # average the last few steps so one lucky batch can't stop training
        if len(losses) >= 5 and sum(losses[-5:]) / 5 < loss_target:
            break
    return gather_params(params), losses


def save_tiny_lm(params: Dict, path: Path) -> Path:
    from ..engine.checkpoint import save_params

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    return save_params(params, path)


def load_or_train_tiny_lm(
    ckpt_dir: Path,
    cfg: Optional[ModelConfig] = None,
    device=None,
    **train_kwargs,
) -> Tuple[ModelConfig, Dict]:
    """Restore the trained params from ``ckpt_dir`` or train and save
    them, then load them onto ``device`` (None: the card, as
    :func:`train_tiny_lm`). The config used at train time is what the
    checkpoint's shapes encode, so pass the same ``cfg`` (or none, for the
    default) on both sides."""
    import torch

    from ..engine.checkpoint import load_params

    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "load_or_train_tiny_lm places the model on a CUDA device and none is "
            "available; pass device='cpu' explicitly"
        )
    device = torch.device("cuda" if device is None else device)
    if cfg is None:
        cfg = tiny_lm_config()
    path = Path(ckpt_dir) / "tiny_lm"
    if not path.exists():
        params, _ = train_tiny_lm(cfg=cfg, device=device, **train_kwargs)
        save_tiny_lm(params, path)
    return cfg, load_params(path, device=device)
