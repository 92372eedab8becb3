"""The framework-free cases of the JAX package's ``tests/test_quantize.py``
on the port, loaded with the package name swapped:
``TorchEngine(device="cpu")`` at int8 and int4 generates and holds fewer
weight bytes than at full width, refuses an unknown mode, and
``maybe_dequant`` passes a plain tensor through (a torch tensor here).

The other cases build JAX arrays, run the JAX forward or the Pallas int4
kernels, or shard over JAX devices; their port twins hold the same
claims against the JAX functions on the same inputs:
- ``test_quantize_tensor_round_trip_accuracy``: the codes and scales
  equal the JAX ones bit for bit
  (``tests/test_torch_ops.py::test_weight_quantization_codes_match_jax_bit_for_bit``);
- ``test_quantize_params_halves_size``, ``test_int4_pack_roundtrip`` and
  ``test_int4_i32_pack_roundtrip_and_kernel_parity``: leaf for leaf and
  byte for byte like the JAX package
  (``tests/test_torch_quantize_int4.py``: ``test_quantize_params_leaf_for_leaf_like_jax``,
  ``test_params_nbytes_of_int4_like_jax_and_under_045_of_full``,
  ``test_codes_and_dequant_are_bit_identical_to_jax``);
- ``test_quantized_forward_close_to_full_precision`` and
  ``test_int4_forward_close_to_full_precision``: the port's quantized
  forward tracks the JAX one (``tests/test_torch_transformer.py::test_prefill_and_decode_match_jax``,
  ``tests/test_torch_quantize_int4.py::test_bf16_int4_forward_tracks_jax``);
- ``test_int4_pallas_matmul_matches_dequant``,
  ``test_int4_dense_dot_routes_and_matches`` and
  ``test_int4_kernel_disabled_context_uses_einsum``: the Pallas int4
  kernels and their routing (``test_plain_int4_matmuls_match_jax_kernels``,
  ``test_dense_dot_routes_like_jax``; the kernels against their plain
  versions on the card in ``tests/test_torch_kernels_cuda.py``);
- ``test_embed_rowwise_scales_resist_outlier_rows``: the embedding's
  row-wise codes equal the JAX ones (``test_quantize_params_leaf_for_leaf_like_jax``);
- ``test_tp_engine_with_int8`` and ``test_tp_engine_with_int4``: the
  sharded engine at int8 and int4 equals the unsharded one
  (``tests/test_torch_parallel.py::test_tp_quantized_weights_match_unsharded``).
"""

from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp\n", "import jax.numpy as jnp\nimport torch\n"),
    ("    w = jnp.ones((4, 4))\n", "    w = torch.ones((4, 4))\n"),
)
ONLY = (
    "test_maybe_dequant_passthrough",
    "test_engine_int8_generates_and_shrinks",
    "test_engine_rejects_unknown_quantize",
    "test_engine_int4_generates_and_shrinks",
)
CASES = load_cases(globals(), "test_quantize.py", renames=RENAMES, only=ONLY)
