"""B11's plain version against the JAX package's w4a8 probe.

``scripts/w4a8_probe.py::w4a8_matmul`` quantizes x per row outside its
Pallas kernel and runs the kernel (interpret mode on the CPU). The port's
``quantize_activations_rowwise`` gives the probe's codes and scales bit
for bit as the probe's eager call computes them; under ``jax.jit`` XLA
turns ``/ 127.0`` into a multiply by the f32 reciprocal, which moves some
scales by one ulp (ROADMAP Queue C), so the jitted codes are held to one
code and one ulp. ``w4a8_matmul_reference`` (what ``cuda_w4a8_matmul``
computes on the CPU) equals the probe's eager output exactly (tolerance
0: both sum integers exactly and apply the two scales in one order), at
IN 256 → OUT 512 and at an OUT that is not a multiple of the probe's
512-column block, also with a zero row (0/0 gives code 0 on both sides,
and an output row of zeros) and with a row of a single nonzero entry; its
error against the dequantized f32 product is the probe's.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.quantize import (
    maybe_dequant,
    quantize_tensor_int4 as jax_quantize_int4,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import quantize_tensor_int4
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import quant as tq

REPO = pathlib.Path(__file__).resolve().parent.parent
M = 8  # the probe's rows


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("w4a8_probe", REPO / "scripts" / "w4a8_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # main() runs only as a script
    return mod


def _probe_codes(x):
    """The probe's activation math (``w4a8_matmul``'s first two lines)."""
    sx = jnp.max(jnp.abs(x), axis=1, keepdims=True).astype(jnp.float32) / 127.0
    xq = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
    return xq, sx


def _x(seed, in_dim):
    """bf16 activations, as the probe feeds them: (jax array, torch tensor)."""
    x = np.random.default_rng(seed).standard_normal((M, in_dim)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_activation_codes_match_the_probe(seed):
    xj, xt = _x(seed, 1536)
    xq, sx = tq.quantize_activations_rowwise(xt)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (M, 1)
    eq, es = _probe_codes(xj)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(eq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(es))
    jq, js = jax.jit(_probe_codes)(xj)
    ulps = np.abs(sx.numpy().view(np.int32) - np.asarray(js).view(np.int32))
    assert ulps.max() <= 1
    assert np.abs(xq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)).max() <= 1


@pytest.mark.parametrize(
    "in_dim,out_dim,row",
    [(256, 512, None), (512, 640, None), (256, 512, "zero"), (512, 640, "one")],
    ids=["256-512", "512-640", "256-512-zero_row", "512-640-one_nonzero"],
)
def test_plain_w4a8_equals_the_probe_kernel(probe, in_dim, out_dim, row):
    rng = np.random.default_rng(in_dim + out_dim)
    w = (rng.standard_normal((in_dim, out_dim)) * 0.05).astype(np.float32)
    leaf = jax_quantize_int4(jnp.asarray(w))
    xj, xt = _x(in_dim, in_dim)
    if row == "zero":  # 0/0 in the quantization: code 0 on both sides, an output row of zeros
        xj, xt = xj.at[3].set(0), xt.clone()
        xt[3] = 0
    elif row == "one":  # a single nonzero entry: its code is ±127, the rest 0
        xj = xj.at[5].set(0).at[5, 17].set(-0.8125)
        xt = xt.clone()
        xt[5] = 0
        xt[5, 17] = -0.8125
    want = np.asarray(probe.w4a8_matmul(xj, leaf["q4"], leaf["s"]))
    tleaf = quantize_tensor_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(tleaf["q4"].numpy(), np.asarray(leaf["q4"]))
    np.testing.assert_array_equal(tleaf["s"].numpy(), np.asarray(leaf["s"]))
    got = cuda_quant.cuda_w4a8_matmul(xt, tleaf["q4"], tleaf["s"])  # the CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (M, out_dim)
    np.testing.assert_array_equal(got.numpy(), want)
    if row == "zero":
        assert not want[3].any()
    if row == "one":
        np.testing.assert_array_equal(tq.quantize_activations_rowwise(xt)[0][5].nonzero().flatten().numpy(), [17])
    # its error against the f32 product of the dequantized weights is the probe's
    ref = np.asarray(xj.astype(jnp.float32) @ maybe_dequant(leaf, jnp.float32))
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    probe_err = np.abs(want - ref).max() / np.abs(ref).max()
    assert err == probe_err and 0 < err < 0.05


def test_w4a8_shape_contract():
    leaf = quantize_tensor_int4(torch.randn(200, 128))
    with pytest.raises(ValueError, match="not a multiple of 128"):
        cuda_quant.cuda_w4a8_matmul(torch.randn(M, 200), leaf["q4"], leaf["s"])
    leaf = quantize_tensor_int4(torch.randn(256, 128))
    with pytest.raises(ValueError, match="rows"):
        cuda_quant.cuda_w4a8_matmul(torch.randn(9, 256), leaf["q4"], leaf["s"])
