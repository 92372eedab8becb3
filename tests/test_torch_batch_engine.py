"""``TorchEngine.generate_batch`` over the paged pool against the JAX
package's paged engine, on the same (bridged) tiny weights in float32.

The JAX engine runs its stacked-hybrid mode with the Pallas parts kernel
(interpret mode on the CPU; ``PAGED_XLA_PARTS_MIN_ROWS`` raised so its
XLA-gather routing stays off), the port its plain parts versions. The
batch mixes prompts of 1–4 pages at page 128, a prompt that prefills in
two chunks (``PREFILL_CHUNK`` shrunk in both engines), a same-bucket pair
that prefills as one group, a greedy row with a repeat penalty and a
sampled row (with top-p and a repeat penalty); six rows pad to a bucket of
eight. Greedy rows' tokens and text must be identical, with a bf16-style
(unquantized) pool and with int8 weights and an int8 pool, on GQA (qwen2)
and MHA (phi3) models. The sampled row must equal the port's own solo
``generate`` of the same request (the two frameworks' random streams
differ, so it is not compared with the JAX engine's).

At int4 and int4-i32 weights the six rows pad to a batch bucket of 8, so
decode takes the int4 kernel route in both engines (the JAX engine's
Pallas int4 kernels in interpret mode); a batch of more than 8 rows
dequantizes and multiplies in both, and its greedy rows must be identical
too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine import jax_engine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops.pallas_attention import (
    pallas_decode_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as tquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)

CHUNK = 256  # PREFILL_CHUNK shrunk: the 450-token prompt prefills in 2 chunks
# (prompt, max_new_tokens, sampling kwargs); the byte tokenizer adds a BOS
ROWS = [
    ("a short row", 12, {}),  # bucket 32, 1 page
    ("b" * 149, 20, {}),  # bucket 256, 2 pages
    ("the second row of bucket 256, " * 5, 9, {}),  # groups with the row above
    ("c" * 299, 16, dict(repeat_penalty=1.3)),  # bucket 512, 3 pages
    ("d" * 449, 10, {}),  # 2 chunks, 4 pages
    # groups with row 0
    ("sampled row", 14, dict(temperature=0.7, seed=1, top_p=0.9, repeat_penalty=1.1)),
]
CONFIGS = {
    "bf16-pool": {},
    "int8-pool": dict(quantize="int8", kv_quantize="int8"),
    "int4": dict(quantize="int4"),
    "int4-i32": dict(quantize="int4-i32"),
}
MODELS = {"qwen2": "qwen2:1.5b", "phi3": "phi3:3.8b"}  # GQA, MHA


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name = MODELS[request.param]
    cfg = get_model_config(name).tiny(vocab_size=259, max_seq_len=1024)
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(4), jnp.float32))
    return name, params


def _engines(model, config):
    name, np_params = model
    kw = CONFIGS[config]
    jeng = JaxEngine(
        registry={}, dtype=jnp.float32, paged_kv=True,
        decode_attention=pallas_decode_attention, **kw,
    )
    jeng.install_model(
        "tiny", get_model_config(name).tiny(vocab_size=259, max_seq_len=1024),
        jax.tree.map(jnp.asarray, np_params),
    )
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", paged_kv=True, **kw)
    teng.install_model(
        "tiny", port_config(name).tiny(vocab_size=259, max_seq_len=1024),
        params_from_numpy(np_params, "cpu", torch.float32),
    )
    return jeng, teng


@pytest.mark.parametrize("config", list(CONFIGS))
def test_paged_batch_tokens_equal_jax_paged_engine(model, config, monkeypatch):
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    monkeypatch.setattr(jax_engine, "PREFILL_CHUNK", CHUNK)
    monkeypatch.setattr(torch_engine, "PREFILL_CHUNK", CHUNK)
    assert len(torch_engine._prompt_chunks(len(ROWS[4][0]) + 1)) == 2
    jeng, teng = _engines(model, config)
    assert jeng._paged_decode_attention() is not None  # the stacked-hybrid mode
    jreqs = [JaxRequest("tiny", p, n, stop_at_eos=False, **kw) for p, n, kw in ROWS]
    treqs = [GenerationRequest("tiny", p, n, stop_at_eos=False, **kw) for p, n, kw in ROWS]
    want = jeng.generate_batch(jreqs)
    got = teng.generate_batch(treqs)
    assert len(got) == len(ROWS)
    for (prompt, n, kw), g, w in zip(ROWS, got, want):
        assert g.prompt_tokens == w.prompt_tokens == len(prompt) + 1
        assert g.generated_tokens == len(g.tokens) == n  # stop_at_eos=False, no EOS
        if kw.get("temperature"):
            continue
        assert g.tokens == w.tokens, (config, prompt)
        assert g.text == w.text
    solo = teng.generate(treqs[-1])
    assert got[-1].tokens == solo.tokens
    # one shared decode window for the sub-batch
    assert len({r.extras["decode_window"] for r in got}) == 1
    assert all(r.decode_s == got[0].decode_s > 0 for r in got)


@pytest.mark.parametrize("mode", ["int4", "int4-i32"])
def test_int4_batch_of_more_than_eight_rows_equals_jax(model, mode, monkeypatch):
    """Ten greedy rows (bucket 16): every decode matmul has more than 8 rows
    and dequantizes, in both engines; a two-row batch of the same engine
    takes the kernel route (its plain version on the CPU)."""
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    name = "cuda_int4_matmul" if mode == "int4" else "cuda_int4_matmul_i32"
    calls = []
    real = getattr(tquant, name)
    monkeypatch.setattr(tquant, name, lambda *a: calls.append(a[0].shape[0]) or real(*a))
    jeng, teng = _engines(model, mode)
    prompts = [(p, n) for p, n, kw in ROWS[:3] if not kw] + [(f"row {i} " * (i + 1), 6) for i in range(7)]
    want = jeng.generate_batch([JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in prompts])
    got = teng.generate_batch([GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in prompts])
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert calls == []
    teng.generate_batch([GenerationRequest("tiny", p, 4, stop_at_eos=False) for p, _ in prompts[:2]])
    assert calls and set(calls) == {2}


def test_batch_rows_stop_at_eos_and_stop_strings_like_solo(model, monkeypatch):
    """Per-row ends: stop strings cut each row as its solo ``generate``
    cuts it, and a budget of one token skips the decode loop for that row."""
    _, teng = _engines(model, "bf16-pool")
    full = teng.generate(GenerationRequest("tiny", "stop here", 40, stop_at_eos=False))
    stop = (full.text[5:7],)
    reqs = [
        GenerationRequest("tiny", "stop here", 40, stop=stop, stop_at_eos=False),
        GenerationRequest("tiny", "one token", 1),
        GenerationRequest("tiny", "plain row", 8),
    ]
    got = teng.generate_batch(reqs)
    for r, g in zip(reqs, got):
        solo = teng.generate(r)
        assert (g.tokens, g.text) == (solo.tokens, solo.text)
    assert got[1].generated_tokens <= 1


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_admission_estimates_equal_jax_engines(size):
    """Row caps of the batch splitter and the admission probe, for tiny
    qwen2 and for full-width qwen2:1.5b (head dim 128, where the JAX
    engine's lane padding adds nothing, so the byte bills are equal and a
    2.5 GB budget binds); estimates only, nothing loads."""
    name = "qwen2:1.5b"
    jcfg = get_model_config(name)
    tcfg = port_config(name)
    if size == "tiny":
        jcfg, tcfg = jcfg.tiny(), tcfg.tiny()
    lens = (26, 235, 913, 3697)
    for kw in ({}, dict(paged_kv=True), dict(paged_kv=True, kv_quantize="int8")):
        jeng = JaxEngine(
            registry={"m": jcfg}, dtype=jnp.bfloat16,
            decode_attention=pallas_decode_attention, **kw,
        )
        teng = TorchEngine(registry={"m": tcfg}, dtype=torch.bfloat16, device="cpu", **kw)
        for rows in (40, 256):
            ids = [[1] * lens[i % 4] for i in range(rows)]
            jr = [JaxRequest("m", "x", 256)] * rows
            tr = [GenerationRequest("m", "x", 256)] * rows
            assert teng._max_batch_rows(tcfg, tr, ids) == jeng._max_batch_rows(jcfg, jr, ids)
        for prompt, n in (("hi", 16), ("m" * 1800, 256)):
            assert teng.max_admission_rows(GenerationRequest("m", prompt, n)) == (
                jeng.max_admission_rows(JaxRequest("m", prompt, n))
            )
        assert not teng._models


def test_admission_estimates_shrink_the_batch(monkeypatch):
    """Under a tight budget a fleet splits into sequential sub-batches,
    each its own decode window, with every row still equal to solo."""
    monkeypatch.setattr(torch_engine, "BATCH_MIN_SPLIT_ROWS", 2)
    monkeypatch.setattr(torch_engine, "BATCH_KV_BUDGET_BYTES", 1)
    teng = TorchEngine(
        registry={"tiny": port_config("qwen2:1.5b").tiny(vocab_size=259)},
        dtype=torch.float32, device="cpu", paged_kv=True,
    )
    reqs = [GenerationRequest("tiny", f"row {i}", 6 + i) for i in range(5)]
    got = teng.generate_batch(reqs)
    assert len({r.extras["decode_window"] for r in got}) == 3  # 2 + 2 + 1 rows
    for r, g in zip(reqs, got):
        assert g.tokens == teng.generate(r).tokens


def test_batch_guards():
    teng = TorchEngine(
        registry={"tiny": port_config("qwen2:1.5b").tiny()}, device="cpu", paged_kv=True
    )
    assert teng.generate_batch([]) == []
    with pytest.raises(ValueError, match="one model"):
        teng.generate_batch([GenerationRequest("tiny", "a", 2), GenerationRequest("other", "b", 2)])
    with pytest.raises(ValueError, match="top_k"):
        teng.generate_batch([
            GenerationRequest("tiny", "a", 2, top_k=2), GenerationRequest("tiny", "b", 2),
        ])
    with pytest.raises(ValueError, match="page_size"):
        TorchEngine(device="cpu", paged_kv=True, page_size=100)
