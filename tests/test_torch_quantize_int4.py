"""The port's int4 weight modes against the JAX package's, on the CPU.

- Codes and scales of both int4 layouts (halves ``q4`` and int32 lanes
  ``q32``) are bit-identical to the JAX package's, at flat and stacked
  shapes with ±max and all-zero columns, and so is ``maybe_dequant``.
- Whole parameter dicts quantize leaf for leaf as the JAX package's do:
  embeddings and an untied ``lm_head`` stay int8 in every mode.
- The plain int4 matmuls agree with the JAX kernels (Pallas interpret mode)
  at M 1/5/8 within 1e-4 (float32 sums taken in another order).
- ``dense_dot`` takes the kernel route on exactly the leaves and shapes
  where the JAX package's does, with float32 and bfloat16 activations.
- In bfloat16 a prefill and 8 teacher-forced decode steps (dequant route,
  then kernel route) track the JAX package's logits. bf16 rounds at other
  places in the two frameworks, so greedy tokens of long bf16 generations
  part ways even without quantization; the float32 engines' tokens are
  compared exactly in ``test_torch_engine.py`` and
  ``test_torch_batch_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import quantize as jquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import transformer as jtf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_quant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as tquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import transformer as ttf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import quant as tq
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

TOL = dict(atol=1e-4, rtol=1e-4)
MODES = {  # mode -> (code key, JAX quantizer, port quantizer)
    "int4": ("q4", jquant.quantize_tensor_int4, tquant.quantize_tensor_int4),
    "int4-i32": ("q32", jquant.quantize_tensor_int4_i32, tquant.quantize_tensor_int4_i32),
}


def _np(leaf):
    return {k: np.array(v) for k, v in leaf.items()}  # writable copies


def _weights(rng, shape):
    """Normal weights with an all-zero column, and one column whose
    largest |w| is at +max and one at -max (codes ±7 at the packing's
    sign bit)."""
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0
    w[..., 1, 1] = 50.0
    w[..., -1, 2] = -50.0
    return w


@pytest.mark.parametrize("shape", [(64, 40), (3, 48, 24)], ids=["flat", "stacked"])
@pytest.mark.parametrize("mode", list(MODES))
def test_codes_and_dequant_are_bit_identical_to_jax(mode, shape):
    key, jfn, tfn = MODES[mode]
    w = _weights(np.random.default_rng(0), shape)
    j = _np(jfn(jnp.asarray(w)))
    t = tfn(torch.from_numpy(w))
    assert t[key].dtype == (torch.int8 if key == "q4" else torch.int32)
    np.testing.assert_array_equal(t[key].numpy(), j[key])
    np.testing.assert_array_equal(t["s"].numpy(), j["s"])
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.maybe_dequant(jax.tree.map(jnp.asarray, j), jd), np.float32)
        np.testing.assert_array_equal(tquant.maybe_dequant(t, td).float().numpy(), want)
    # zero column: zero codes and weights; ±max columns dequantize to ±max
    deq = tquant.maybe_dequant(t, torch.float32).numpy()
    assert not deq[..., 0].any()
    np.testing.assert_allclose(deq[..., 1, 1], 50.0, rtol=1e-6)
    np.testing.assert_allclose(deq[..., -1, 2], -50.0, rtol=1e-6)


def test_int32_lanes_wrap_into_the_sign_bit():
    """A negative code at nibble 7 sets bit 31 of the lane: the lane is a
    negative int32 and unpacks back to the code."""
    w = np.zeros((8, 4), np.float32)
    w[7] = [-1.0, 1.0, -0.5, 0.0]
    w[0] = [0.2, -0.3, 1.0, 1.0]
    t = tquant.quantize_tensor_int4_i32(torch.from_numpy(w))
    j = _np(jquant.quantize_tensor_int4_i32(jnp.asarray(w)))
    np.testing.assert_array_equal(t["q32"].numpy(), j["q32"])
    assert t["q32"][0, 0] < 0 and t["q32"][0, 1] > 0
    np.testing.assert_array_equal(
        tq.unpack_int4_i32(t["q32"])[:, 0].numpy(), [1, 0, 0, 0, 0, 0, 0, -7]
    )


@pytest.mark.parametrize(
    "mode,in_dim", [("int4", 63), ("int4-i32", 60)], ids=["odd-in", "in-not-div-8"]
)
def test_unpackable_in_dims_raise(mode, in_dim):
    _, jfn, tfn = MODES[mode]
    w = np.ones((in_dim, 16), np.float32)
    with pytest.raises(ValueError):
        jfn(jnp.asarray(w))
    with pytest.raises(ValueError, match="input-feature dim"):
        tfn(torch.from_numpy(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int4", "int4-i32"])
def test_quantize_params_leaf_for_leaf_like_jax(mode, dtype):
    """phi3 (untied head) and qwen2 (tied, qkv bias): every leaf the JAX
    package quantizes comes out with the same keys, codes and scales; the
    embedding and the untied head are int8 in every mode."""
    for model in ("phi3:3.8b", "qwen2:1.5b"):
        cfg = get_model_config(model).tiny()
        jp = jtf.init_params(cfg, jax.random.PRNGKey(5), getattr(jnp, dtype))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", getattr(torch, dtype))
        want = jax.tree.map(np.asarray, jquant.quantize_params(jp, mode=mode))
        got = tquant.quantize_params(tp, mode=mode)
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            if not isinstance(want[name], dict):
                assert not tquant.is_quantized(leaf)
                continue
            assert sorted(leaf) == sorted(want[name]), name
            for k, v in leaf.items():
                np.testing.assert_array_equal(v.numpy(), want[name][k], err_msg=f"{name}.{k}")
        assert set(got["embed"]) == {"q", "s"}
        if "lm_head" in got:
            assert set(got["lm_head"]) == {"q", "s"}


@pytest.mark.parametrize("mode", list(MODES))
def test_params_nbytes_of_int4_like_jax_and_under_045_of_full(mode):
    cfg = get_model_config("qwen2:1.5b").tiny()
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    jq4 = jquant.quantize_params(jp, mode=mode)
    full = tquant.params_nbytes(params_from_numpy(jax.tree.map(np.asarray, jp)))
    q4 = tquant.params_nbytes(params_from_numpy(jax.tree.map(np.asarray, jq4)))
    assert full == jquant.params_nbytes(jp)
    assert q4 == jquant.params_nbytes(jq4)
    assert q4 < 0.45 * full


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_int4_matmuls_match_jax_kernels(mode, m):
    """IN 192 (24 int32 lanes, which the JAX i32 kernel pads to 128), OUT
    384; x in float32, which both round to bf16 before the product."""
    key, jfn, tfn = MODES[mode]
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((192, 384)) / np.sqrt(192)).astype(np.float32)
    x = rng.standard_normal((m, 192)).astype(np.float32)
    leaf = _np(jfn(jnp.asarray(w)))
    jkernel = pallas_quant.int4_matmul if key == "q4" else pallas_quant.int4_matmul_i32
    tref = tq.int4_matmul_reference if key == "q4" else tq.int4_matmul_i32_reference
    wrapper = cuda_quant.cuda_int4_matmul if key == "q4" else cuda_quant.cuda_int4_matmul_i32
    want = np.asarray(jkernel(jnp.asarray(x), jnp.asarray(leaf[key]), jnp.asarray(leaf["s"])))
    args = (torch.from_numpy(x), torch.from_numpy(leaf[key]), torch.from_numpy(leaf["s"]))
    got = tref(*args)
    assert got.dtype == torch.float32 and got.shape == (m, 384)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = wrapper.launches
    torch.testing.assert_close(wrapper(*args), got, rtol=0, atol=0)
    assert wrapper.launches == before
    # bf16 x: one rounding of the f32 result
    xb = torch.from_numpy(x).to(torch.bfloat16)
    torch.testing.assert_close(tref(xb, *args[1:]), got.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_wrappers_check_the_contract_on_every_device(mode):
    key, _, tfn = MODES[mode]
    wrapper = cuda_quant.cuda_int4_matmul if key == "q4" else cuda_quant.cuda_int4_matmul_i32
    leaf = tfn(torch.ones(64, 128))
    with pytest.raises(ValueError, match="rows"):
        wrapper(torch.ones(9, 64), leaf[key], leaf["s"])
    with pytest.raises(ValueError, match="in-dim"):
        wrapper(torch.ones(2, 32), leaf[key], leaf["s"])
    with pytest.raises(ValueError, match="codes must be"):
        wrapper(torch.ones(2, 64), leaf[key].to(torch.int16), leaf["s"])


@pytest.mark.parametrize("layout", [0, 1], ids=["halves", "i32"])
@pytest.mark.parametrize(
    "in_dim,out_dim",
    [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),  # qwen2:1.5b
     (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),  # llama3.1:8b
     (96, 200), (16, 8)],
)
def test_k_splits_cover_the_packed_rows_within_the_kernel_limit(in_dim, out_dim, layout):
    per_row = 8 if layout else 2  # weight rows per packed row
    k_rows = in_dim // per_row
    tiles = -(-out_dim // 128)
    n_split, rows = cuda_quant._mma_split(k_rows, out_dim, per_row)
    assert (n_split - 1) * rows < k_rows <= n_split * rows
    # B9 and B10 share one rule in weight rows: whole k-steps (8 packed
    # rows of the halves layout, 4 of the int32 lanes), at least 256 and
    # at most 2,048 weight rows a split (the x slice the kernels stage)
    assert rows % (8 if per_row == 2 else 4) == 0
    assert 256 <= rows * per_row <= cuda_quant._MMA_MAX_SPLIT_WEIGHT_ROWS == 2048
    # at most one block per SM unless the tiles alone are more or the x
    # slice forces more splits: more, shorter splits were slower at every
    # shape swept on the card (PERF.md §6)
    assert n_split * tiles <= max(132, tiles) or rows * per_row == 2048
    if in_dim >= 1536:  # split wherever the column tiles leave SMs idle
        assert n_split >= min(132 // tiles, in_dim // 256)


# (code key, B, S, IN, OUT, kernel route in the JAX package)
ROUTES = [
    ("q4", 1, 1, 64, 128, True),
    ("q4", 2, 4, 64, 128, True),
    ("q4", 3, 3, 64, 128, False),  # 9 rows
    ("q4", 1, 1, 64, 64, False),  # OUT % 128
    ("q4", 1, 1, 48, 128, False),  # IN/2 % 32
    ("q32", 1, 1, 64, 128, True),
    ("q32", 8, 1, 48, 256, True),  # 6 lanes: the JAX kernel pads them
    ("q32", 1, 1, 64, 96, False),  # OUT % 128
    ("q32", 4, 3, 64, 128, False),  # 12 rows
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key,b,s,in_dim,out_dim,kernel", ROUTES)
def test_dense_dot_routes_like_jax(monkeypatch, key, b, s, in_dim, out_dim, kernel, dtype):
    """Same route, same values: float32 within 1e-4; bfloat16 within one
    bf16 rounding of the f32 sums (2^-7 relative, 2e-2 absolute)."""
    mode = "int4" if key == "q4" else "int4-i32"
    _, jfn, _ = MODES[mode]
    rng = np.random.default_rng(in_dim + out_dim)
    w = (rng.standard_normal((in_dim, out_dim)) / np.sqrt(in_dim)).astype(np.float32)
    x = rng.standard_normal((b, s, in_dim)).astype(np.float32)
    leaf = _np(jfn(jnp.asarray(w)))
    calls = {"jax": 0, "port": 0}

    def spy(side, fn):
        def wrapped(*a):
            calls[side] += 1
            return fn(*a)
        return wrapped

    jname = "int4_matmul" if key == "q4" else "int4_matmul_i32"
    tname = "cuda_int4_matmul" if key == "q4" else "cuda_int4_matmul_i32"
    monkeypatch.setattr(pallas_quant, jname, spy("jax", getattr(pallas_quant, jname)))
    monkeypatch.setattr(tquant, tname, spy("port", getattr(tquant, tname)))
    tleaf = {k: torch.from_numpy(v) for k, v in leaf.items()}
    jleaf = jax.tree.map(jnp.asarray, leaf)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jquant.dense_dot(jx, jleaf).astype(jnp.float32))
    got_t = tquant.dense_dot(tx, tleaf)
    assert got_t.dtype == tx.dtype
    got = got_t.float().numpy()
    assert calls == {"jax": int(kernel), "port": int(kernel)}
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2**-7)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", ["qwen2:1.5b", "phi3:3.8b"])
def test_bf16_int4_forward_tracks_jax(model, mode):
    """bf16 weights and activations, int4 leaves: a 12-token prefill
    (dequant route) and 8 teacher-forced decode steps (kernel route on
    w_gate/w_up, OUT 128). bf16 keeps 8 significant bits (a step of 2^-8
    of the value), and the two frameworks round at other places through
    two layers: logits agree within 5 such steps of the largest logit
    (0.02·max|logit|), and the greedy token agrees at every step."""
    cfg = get_model_config(model).tiny()
    tcfg = port_config(model).tiny()
    jp = jquant.quantize_params(jtf.init_params(cfg, jax.random.PRNGKey(1), jnp.bfloat16), mode=mode)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, size=(1, 20)).astype(np.int32)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 32, cfg.d_head)
    jk = jv = jnp.zeros(shape, jnp.bfloat16)
    tk, tv = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16)
    steps = [(0, 12)] + [(p, p + 1) for p in range(12, 20)]
    for start, end in steps:
        tok = tokens[:, start:end]
        jh, jk, jv = jtf.forward(jp, cfg, jnp.asarray(tok), jnp.int32(start), jk, jv)
        th, _, _ = ttf.forward(tp, tcfg, torch.from_numpy(tok).long(), start, tk, tv)
        want = np.asarray(jtf.logits_for(jp, cfg, jh[:, -1]))
        got = ttf.logits_for(tp, tcfg, th[:, -1]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
        assert got.argmax() == want.argmax(), (start, end)


@pytest.mark.parametrize("mode", list(MODES))
def test_bridge_carries_int4_codes_exactly(mode):
    """int8 ``q4`` and int32 ``q32`` codes cross the bridge unchanged (no
    float conversion), scales as float32, plain leaves at the asked dtype."""
    key, _, _ = MODES[mode]
    cfg = get_model_config("llama3.1:8b").tiny()
    jp = jquant.quantize_params(jtf.init_params(cfg, jax.random.PRNGKey(7), jnp.float32), mode=mode)
    np_params = jax.tree.map(np.asarray, jp)
    got = params_from_numpy(np_params, "cpu", torch.bfloat16)
    for name in tquant.DEFAULT_QUANT_KEYS:
        assert set(got[name]) == {key, "s"}
        assert got[name][key].dtype == (torch.int8 if key == "q4" else torch.int32)
        np.testing.assert_array_equal(got[name][key].numpy(), np_params[name][key])
        assert got[name]["s"].dtype == torch.float32
        np.testing.assert_array_equal(got[name]["s"].numpy(), np_params[name]["s"])
    assert got["final_norm"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not a quantized leaf"):
        params_from_numpy({"wq": {"q8": np_params["wq"][key], "s": np_params["wq"]["s"]}})
