"""The port's ``models/tiny_lm.py`` against the JAX package's on the CPU.

Twins of ``tests/test_tiny_lm.py``'s four cases on the port (trained with
the port's own step on the CPU, served by ``TorchEngine(device="cpu")``),
the corpus and its packed rows equal to the JAX package's bit for bit,
the config equal, 3 training steps of the port's ``make_train_step`` at
the tiny LM's config against the JAX step on the same bridged init and
the same batch draw, and the refusal to train without a card unless the
caller asks for the CPU. The JAX tiny LM is never trained here: the
port's convergence case trains the port only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import tiny_lm as jax_tiny_lm
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import (
    Transformer as JaxTransformer,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import mesh as jmesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel.train import (
    make_train_step as jax_make_train_step,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import is_quantized
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.tiny_lm import (
    TINY_LM_NAME,
    _pack_rows,
    build_corpus,
    load_or_train_tiny_lm,
    save_tiny_lm,
    tiny_lm_config,
    train_tiny_lm,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.train import make_train_step
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

SMALL = dict(d_model=96, n_layers=3)  # tests/test_tiny_lm.py's model


@pytest.fixture(scope="module")
def trained():
    cfg = tiny_lm_config(**SMALL)
    corpus = build_corpus()[:16]
    params, losses = train_tiny_lm(cfg=cfg, corpus=corpus, steps=600, batch=16, seq_len=96, device="cpu")
    return cfg, corpus, params, losses


def test_training_converges(trained):
    _, _, _, losses = trained
    assert losses[0] > 3.0  # random init: ~ln(vocab)
    assert losses[-1] < 0.3  # memorised the corpus
    assert len(losses) < 600  # early-stopped at the loss target


def test_trained_model_generates_eos_driven_text(trained):
    cfg, corpus, params, _ = trained
    engine = TorchEngine(registry={}, dtype=torch.float32, device="cpu")
    engine.install_model(TINY_LM_NAME, cfg, params)
    prompt = corpus[0][: corpus[0].index(".") + 1]  # first sentence prefix
    budget = 134
    r = engine.generate(GenerationRequest(TINY_LM_NAME, prompt, max_new_tokens=budget))
    # the whole point: content-driven length, not budget-driven
    assert 0 < r.generated_tokens < budget
    assert r.text  # readable learned bytes, not empty
    assert all(32 <= ord(c) < 127 or c.isspace() for c in r.text)


def test_install_model_applies_engine_quantization(trained):
    cfg, _, params, _ = trained
    engine = TorchEngine(registry={}, dtype=torch.float32, quantize="int8", device="cpu")
    engine.install_model(TINY_LM_NAME, cfg, params)
    assert is_quantized(engine._models[TINY_LM_NAME].params["wq"])
    r = engine.generate(GenerationRequest(TINY_LM_NAME, "Here is information", max_new_tokens=8))
    assert r.generated_tokens >= 1


def test_load_or_train_round_trips(tmp_path, trained):
    cfg, _, params, _ = trained
    save_tiny_lm(params, tmp_path / "tiny_lm")
    cfg2, restored = load_or_train_tiny_lm(tmp_path, cfg=cfg, device="cpu")
    assert cfg2 == cfg
    assert set(restored) == set(params)
    for name, leaf in params.items():
        assert torch.equal(restored[name], leaf), name


def test_corpus_rows_and_config_match_jax():
    corpus = build_corpus()
    assert corpus == jax_tiny_lm.build_corpus()
    assert _pack_rows(corpus, 96) == jax_tiny_lm._pack_rows(corpus, 96)
    assert _pack_rows(corpus[:3], 20) == jax_tiny_lm._pack_rows(corpus[:3], 20)  # cut rows
    assert dataclasses.asdict(tiny_lm_config(**SMALL)) == dataclasses.asdict(jax_tiny_lm.tiny_lm_config(**SMALL))
    assert tiny_lm_config().d_head == 32


def test_train_steps_match_jax():
    """train_tiny_lm's loop for 3 steps (the tiny LM's config, learning
    rate and batch draw; no remat) on the same bridged init: the losses
    agree within 1e-4."""
    cfg = tiny_lm_config(**SMALL)
    jcfg = jax_tiny_lm.tiny_lm_config(**SMALL)
    data = np.asarray(_pack_rows(build_corpus()[:16], 96), dtype=np.int32)
    rng = np.random.default_rng(0)
    batches = [data[rng.integers(0, len(data), size=16)] for _ in range(3)]
    init = JaxTransformer.initialise(jcfg, seed=0, dtype=jnp.float32).params
    np_params = jax.tree.map(np.asarray, init)

    jmesh_ = jmesh.build_mesh(jmesh.MeshSpec.dp_tp(1, 1), jax.devices()[:1])
    jinit, jstep = jax_make_train_step(jcfg, jmesh_, learning_rate=3e-3, remat=False)
    jparams, jopt = jinit(init)
    mesh = build_mesh(MeshSpec.dp_tp(1, 1), ["cpu"])
    tinit, tstep = make_train_step(cfg, mesh, learning_rate=3e-3, remat=False)
    tparams, topt = tinit(params_from_numpy(np_params))
    want, got = [], []
    for batch in batches:
        jparams, jopt, loss = jstep(jparams, jopt, jnp.asarray(batch))
        want.append(float(loss))
        tparams, topt, loss = tstep(tparams, topt, batch)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_tiny_lm_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_tiny_lm(cfg=tiny_lm_config(**SMALL), steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_or_train_tiny_lm("unused", cfg=tiny_lm_config(**SMALL))
