"""The framework-free cases of the JAX package's
``tests/test_paged_attention.py`` and ``tests/test_paged_int8.py`` on the
port, loaded with the package name swapped onto
``TorchEngine(device="cpu", paged_kv=True)``: the page pool's allocator,
the paged engine's guards, a paged batch equal to the contiguous batch
and to its rows' solo ``generate`` (bf16 and int8 caches), and the
admission estimates (denser layouts admit wider fleets at an equal
budget; the scheduler takes the backend's estimate). The files'
module-level imports of the Pallas kernels stay the JAX package's, and
no loaded case calls them; the JAX cases' ``decode_attention=`` argument,
which hands the JAX engine a Pallas kernel, is dropped: the port always
runs its own kernels (their plain versions on the CPU).

The other cases run the Pallas kernels in interpret mode, build JAX
arrays, pick between the JAX engine's XLA and Pallas parts paths, or
shard over JAX devices; their port twins:
- the kernels against references (``test_paged_kernel_matches_*``,
  ``test_paged_parts_kernel_*``, ``test_xla_parts_match_kernel_parts``,
  ``test_mixed_length_requests_share_the_pool``,
  ``test_int8_parts_kernel_matches_dequantized_bf16_parts``,
  ``test_xla_int8_parts_match_kernel_and_lane_padded_head_dim``): the
  plain B4/B5/B6 against the Pallas kernels in
  ``tests/test_torch_paged_attention.py`` and
  ``tests/test_torch_paged_write_through.py``, the CUDA kernels against
  them in ``tests/test_torch_kernels_cuda.py``;
- the pool helpers on JAX arrays (``test_write_token_appends_through_the_table``,
  ``test_group_chunks_matches_per_row_paginate``,
  ``test_quantized_page_pool_round_trip``): ``tests/test_torch_paged_kv.py``
  and ``tests/test_torch_paged_write_through.py::test_write_prefill_and_write_token_match_jax``;
- the JAX engine's paths and policies (``test_engine_paged_stacked_pool_matches_contiguous``,
  ``test_paged_int8_stacked_matches_contiguous_int8``,
  ``test_paged_int8_legacy_gather_matches_contiguous_int8``,
  ``test_paged_batch_fused_assembly_with_mixed_groups_and_solo_rows``,
  ``test_paged_kernel_gating_follows_auto_policy``,
  ``test_paged_parts_policy_is_width_and_jmax_aware``): the port has one
  paged mode, the stacked one, held token for token against the JAX
  engine's stacked mode in
  ``tests/test_torch_batch_engine.py::test_paged_batch_tokens_equal_jax_paged_engine``;
- the sharded cases (``test_paged_batch_on_tensor_parallel_engine``,
  ``test_paged_int8_on_tensor_parallel_engine``):
  ``tests/test_torch_parallel.py::test_tp_stacked_paged_parts_parity``.
"""

from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

KEEP = ("ops.pallas_attention", "ops.pallas_paged_attention")
ENGINE = (("engine.jax_engine", "engine.torch_engine"), ("JaxEngine", "TorchEngine"))

CASES = load_cases(globals(), "test_paged_attention.py", renames=ENGINE, keep=KEEP, only=(
    "test_page_pool_allocator",
    "test_paged_kv_guards",
    "test_engine_paged_batch_matches_contiguous_batch",
    "test_engine_paged_batch_matches_single_requests",
))
# the two files share no name but their imports
CASES += load_cases(globals(), "test_paged_int8.py", keep=KEEP, renames=ENGINE + (
    ("        decode_attention=pallas_decode_attention,\n    )\n    reqs", "    )\n    reqs"),
    ("        decode_attention=pallas_decode_attention, **engine_kw\n", "        **engine_kw\n"),
    ("            decode_attention=pallas_decode_attention, **kw\n", "            **kw\n"),
), only=(
    "test_engine_accepts_paged_with_kv_quantize",
    "test_paged_int8_batch_matches_solo",
    "test_equal_budget_admission_is_monotone_in_cache_density",
    "test_max_admission_rows_tracks_cache_density",
    "test_scheduler_budget_aware_admission_uses_backend_estimate",
))
