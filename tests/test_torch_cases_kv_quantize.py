"""The framework-free cases of the JAX package's
``tests/test_kv_quantize.py`` that no other port module loads, with the
package name swapped, on ``TorchEngine(device="cpu")``: an int8 cache
generates the full budget with the bf16 cache's first token, streams the
tokens of ``generate``, refuses a mode it has not, and composes with
speculation. ``tests/test_torch_engine_contiguous.py`` and
``tests/test_torch_prefix_cache.py`` load its batch, residency and
prefix-cache cases.

The other cases build JAX arrays, run the Pallas int8 decode kernel or
read the JAX engine's kernel policy, or shard over JAX devices; their
port twins:
- ``test_kv_cache_quantization_roundtrip``, ``test_quantize_kv_vector_shapes``
  and ``test_quantized_cache_distinct_from_weight_leaf``: the per-vector
  codes and scales equal the JAX ones bit for bit
  (``tests/test_torch_ops.py::test_kv_vector_quantization_matches_jax_bit_for_bit``,
  ``tests/test_torch_paged_kv.py::test_quantize_chunks_codes_are_bit_identical``);
- ``test_int8_decode_kernel_matches_dequantized_reference`` and
  ``test_int8_kernel_parity_at_lane_padded_head_dim``: B3's plain version
  against the Pallas int8 kernel
  (``tests/test_torch_attention.py::test_decode_int8_reference_matches_pallas_int8``),
  the kernel against it on the card (``tests/test_torch_kernels_cuda.py``);
  the port pads no lanes;
- ``test_int8_kernel_engages_for_all_head_dims``: the Pallas "auto" policy;
  the port's kernels take every head width natively
  (``tests/test_torch_kernel_rules.py::test_head_dims_match_every_kernel_switch``);
- ``test_kv_quantize_on_tensor_parallel_engine``: the sharded engine with
  an int8 cache equals the JAX one
  (``tests/test_torch_parallel.py::test_tp_engine_matches_jax_tp_and_unsharded``).
"""

from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (("engine.jax_engine", "engine.torch_engine"), ("JaxEngine", "TorchEngine"))
ONLY = (
    "test_engine_kv_quantize_generates",
    "test_engine_kv_quantize_stream_matches_monolithic",
    "test_kv_quantize_guards",
    "test_kv_quantize_composes_with_speculative_decoding",
)
CASES = load_cases(globals(), "test_kv_quantize.py", renames=RENAMES, only=ONLY)
