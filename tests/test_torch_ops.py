"""The port's small ops against the JAX package's: RoPE, RMSNorm, int8
quantization (codes bit for bit), and sampling (greedy exactly, sampled in
distribution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import quantize as jq
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import norms as jnorms
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import rope as jrope
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import sampling as jsampling
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as tq
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import norms as tnorms
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import rope as trope
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import sampling as tsampling
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

# float32 elementwise math; the two frameworks' transcendental functions
# differ in the last bits only.
OPS_TOL = dict(atol=1e-6, rtol=1e-6)
# chi-squared critical value, df=15 (16 bins), alpha=0.001, and a TV bound
# ~3x the sampling noise at 20k draws per arm (the method of
# tests/test_spec_sampled.py)
CHI2_CRIT_DF15 = 37.697
TV_BOUND = 0.03


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = _rng(1)
    pos = np.array([[0, 1, 7, 300]], dtype=np.int32)
    x = rng.standard_normal((1, 4, 3, 16)).astype(np.float32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 16, theta)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **OPS_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **OPS_TOL)
    out_j = jrope.apply_rope(jnp.asarray(x), jc, js)
    out_t = trope.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **OPS_TOL)


@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_matches_jax(gemma):
    rng = _rng(2)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    out_j = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, gemma_style=gemma)
    out_t = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, gemma_style=gemma)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **OPS_TOL)


@pytest.mark.parametrize(
    "name,shape",
    [("quantize_tensor", (2, 48, 24)), ("quantize_tensor_rowwise", (40, 24))],
)
def test_weight_quantization_codes_match_jax_bit_for_bit(name, shape):
    w = _rng(3).standard_normal(shape).astype(np.float32)
    w[..., 0, 0] = 0.0  # exercise the epsilon scale's neighbourhood
    j = getattr(jq, name)(jnp.asarray(w))
    t = getattr(tq, name)(torch.from_numpy(w))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]), atol=1e-7, rtol=1e-7)
    np.testing.assert_allclose(
        tq.maybe_dequant(t, torch.float32).numpy(),
        np.asarray(jq.maybe_dequant(j, jnp.float32)),
        atol=1e-7, rtol=1e-7,
    )


def test_kv_vector_quantization_matches_jax_bit_for_bit():
    rng = _rng(4)
    v = rng.standard_normal((2, 3, 17, 16)).astype(np.float32) * 3
    v[0, 0, 5] = 0.0  # an unwritten cache position
    jq_, js_ = jq.quantize_kv_vector(jnp.asarray(v))
    tq_, ts_ = tq.quantize_kv_vector(torch.from_numpy(v))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), atol=1e-7, rtol=1e-7)
    jk, _ = jq.quantize_kv_cache(jnp.asarray(v), jnp.asarray(v))
    tk, _ = tq.quantize_kv_cache(torch.from_numpy(v), torch.from_numpy(v))
    np.testing.assert_allclose(
        tq.dequant_cache(tk).numpy(), np.asarray(jq.dequant_cache(jk)), atol=1e-7, rtol=1e-7
    )


def test_quantized_matmul_and_embedding_match_jax():
    rng = _rng(5)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    e = rng.standard_normal((50, 32)).astype(np.float32)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ids = np.array([[0, 7, 49]], dtype=np.int32)
    jw, tw = jq.quantize_tensor(jnp.asarray(w)), tq.quantize_tensor(torch.from_numpy(w))
    je, te = jq.quantize_tensor_rowwise(jnp.asarray(e)), tq.quantize_tensor_rowwise(torch.from_numpy(e))
    np.testing.assert_allclose(
        tq.dense_dot(torch.from_numpy(x), tw).numpy(),
        np.asarray(jq.dense_dot(jnp.asarray(x), jw)),
        **OPS_TOL,
    )
    np.testing.assert_array_equal(
        tq.embed_lookup(te, torch.from_numpy(ids).long(), torch.float32).numpy(),
        np.asarray(jq.embed_lookup(je, jnp.asarray(ids), jnp.float32)),
    )


def _jax_sample(logits, seed, temperature, top_k=0, top_p=None, presence=None, rp=None):
    return np.asarray(
        jsampling.sample_token(
            jnp.asarray(logits), jax.random.PRNGKey(seed), jnp.float32(temperature), top_k,
            None if top_p is None else jnp.float32(top_p),
            None if presence is None else jnp.asarray(presence),
            None if rp is None else jnp.float32(rp),
        )
    )


def _torch_sample(logits, seed, temperature, top_k=0, top_p=None, presence=None, rp=None):
    gen = torch.Generator().manual_seed(seed)
    return tsampling.sample_token(
        torch.from_numpy(logits), gen, temperature, top_k, top_p,
        None if presence is None else torch.from_numpy(presence), rp,
    ).numpy()


KNOBS = [
    pytest.param({}, id="plain"),
    pytest.param({"top_k": 5}, id="top_k"),
    pytest.param({"top_p": 0.8}, id="top_p"),
    pytest.param({"rp": 1.3}, id="repeat_penalty"),
    pytest.param({"top_k": 6, "top_p": 0.9, "rp": 1.2}, id="all"),
]


@pytest.mark.parametrize("knobs", KNOBS)
def test_greedy_sample_token_equals_jax(knobs):
    rng = _rng(6)
    logits = rng.standard_normal((64, 40)).astype(np.float32)
    logits[3, [4, 9]] = 5.0  # a tie: both pick the first index
    presence = rng.random((64, 40)) < 0.3 if "rp" in knobs else None
    j = _jax_sample(logits, 0, 0.0, presence=presence, **knobs)
    t = _torch_sample(logits, 0, 0.0, presence=presence, **knobs)
    np.testing.assert_array_equal(t, j)
    assert t[3] == 4


def _chi2_tv(a, b):
    na, nb = sum(a), sum(b)
    ra, rb = (nb / na) ** 0.5, (na / nb) ** 0.5
    chi2 = sum((ai * ra - bi * rb) ** 2 / (ai + bi) for ai, bi in zip(a, b) if ai + bi)
    tv = 0.5 * sum(abs(ai / na - bi / nb) for ai, bi in zip(a, b))
    return chi2, tv


@pytest.mark.parametrize("knobs", KNOBS)
def test_sampled_sample_token_matches_jax_in_distribution(knobs):
    """Same logits row drawn 20k times by each framework: the token
    histograms (16 bins) must agree by the chi-squared and TV pins."""
    rng = _rng(7)
    row = (rng.standard_normal(16) * 1.5).astype(np.float32)
    logits = np.repeat(row[None], 20_000, axis=0)
    presence = None
    if "rp" in knobs:
        presence = np.repeat((np.arange(16) % 3 == 0)[None], 20_000, axis=0)
    j = _jax_sample(logits, 11, 0.8, presence=presence, **knobs)
    t = _torch_sample(logits, 11, 0.8, presence=presence, **knobs)
    chi2, tv = _chi2_tv(np.bincount(j, minlength=16), np.bincount(t, minlength=16))
    assert chi2 < CHI2_CRIT_DF15, f"chi2={chi2:.2f} tv={tv:.4f}"
    assert tv < TV_BOUND, f"chi2={chi2:.2f} tv={tv:.4f}"


@pytest.mark.parametrize("knobs", [{}, {"top_k": 5}, {"top_p": 0.8}, {"top_k": 6, "top_p": 0.9}])
def test_modified_probs_match_jax(knobs):
    rng = _rng(8)
    logits = (rng.standard_normal((4, 40)) * 2).astype(np.float32)
    temps = np.array([0.5, 0.8, 1.0, 1.7], dtype=np.float32)
    top_p = knobs.get("top_p")
    j = jsampling.modified_probs(
        jnp.asarray(logits), jnp.asarray(temps)[:, None], knobs.get("top_k", 0),
        None if top_p is None else jnp.float32(top_p),
    )
    t = tsampling.modified_probs(
        torch.from_numpy(logits), torch.from_numpy(temps)[:, None], knobs.get("top_k", 0), top_p
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **OPS_TOL)
    # a scalar temperature (sample_token's form) gives the same row
    t1 = tsampling.modified_probs(torch.from_numpy(logits[1:2]), 0.8, knobs.get("top_k", 0), top_p)
    np.testing.assert_allclose(t1.numpy(), t[1:2].numpy(), **OPS_TOL)


def test_sample_token_per_row_greedy_rows_equal_jax():
    rng = _rng(9)
    logits = rng.standard_normal((5, 40)).astype(np.float32)
    presence = rng.random((5, 40)) < 0.3
    rps = np.array([1.0, 1.3, 1.0, 0.7, 1.0], dtype=np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(5))
    j = jsampling.sample_token_per_row(
        jnp.asarray(logits), keys, jnp.zeros(5), 0, None, jnp.asarray(presence), jnp.asarray(rps)
    )
    t = tsampling.sample_token_per_row(
        torch.from_numpy(logits), [None] * 5, [0.0] * 5, 0, None,
        torch.from_numpy(presence), rps.tolist(),
    )
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_sample_token_per_row_draws_each_row_as_its_solo_call():
    """Row b consumes its own generator exactly as a solo ``sample_token``
    on ``logits[b:b+1]`` with that row's knobs: the drawn tokens and the
    generators' states after the draw are the solo calls'."""
    rng = _rng(10)
    logits = torch.from_numpy((rng.standard_normal((4, 40)) * 2).astype(np.float32))
    presence = torch.from_numpy(rng.random((4, 40)) < 0.3)
    temps = [0.7, 0.0, 1.1, 0.0]
    top_ps = [0.9, 1.0, 1.0, 1.0]
    rps = [1.0, 1.0, 1.2, 1.3]
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3, 4)]
    got = tsampling.sample_token_per_row(logits, gens, temps, 5, top_ps, presence, rps)
    for b in range(4):
        solo_gen = torch.Generator().manual_seed(b + 1)
        want = tsampling.sample_token(
            logits[b : b + 1], solo_gen, temps[b], 5,
            top_ps[b] if top_ps[b] < 1.0 else None,
            presence[b : b + 1] if rps[b] != 1.0 else None,
            rps[b] if rps[b] != 1.0 else None,
        )
        assert int(got[b]) == int(want[0])
        assert torch.equal(gens[b].get_state(), solo_gen.get_state())
