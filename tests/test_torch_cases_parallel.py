"""The one case of the JAX package's ``tests/test_parallel.py`` that no
other port module holds and that holds at any device's constants, loaded
with the package name swapped: a whole generation's modelled decode time
is its step count times the step at the mid-loop context
(``parallel/roofline.py``).

Its other cases:
- ``test_mesh_spec_resolution``, ``test_build_mesh_shape``,
  ``test_param_specs_follow_divisibility`` and
  ``test_ring_attention_matches_reference`` have port twins of the same
  names in ``tests/test_torch_parallel.py``, and
  ``test_train_step_dp_tp_runs_and_learns`` in ``tests/test_torch_train.py``;
- ``test_shard_model_places_leaves`` reads a JAX ``NamedSharding``; the
  port's shards put back together give the leaves
  (``tests/test_torch_parallel.py::test_shard_model_round_trip``);
- the sharded engine's cases (``test_tp_engine_matches_single_device_greedy``,
  ``test_tp_generate_batch_matches_single_requests``,
  ``test_tp_generate_stream_matches_monolithic``,
  ``test_tp_speculative_matches_plain_greedy``) build their mesh over 8
  JAX devices; the port's ``generate``, ``generate_batch``,
  ``generate_stream`` and ``generate_speculative`` on meshes of 2 and 8
  CPU shards equal the JAX ``TensorParallelEngine``'s
  (``test_tp_engine_matches_jax_tp_and_unsharded``), and its stacked paged
  parts path too (``test_tp_stacked_paged_parts_parity``, the twin of
  ``test_tp_stacked_paged_parts_kernel_parity``);
- ``test_roofline_single_chip_matches_measured``,
  ``test_roofline_tp_mesh_is_faster_but_sublinear`` and
  ``test_roofline_kv_replication_rule_follows_sharding`` pin the TPU
  v5e's measured step and its ICI constants; the port's model bills the
  H100's data sheet and NVLink (``tests/test_torch_study.py::test_h100_roofline_constants``),
  at which a tp-8 mesh is modelled slower than one card for qwen2:1.5b;
- ``test_roofline_terms_match_aot_lowering`` lowers the JAX step with
  XLA; the port lowers nothing.
"""

from test_torch_runner import load_cases

RENAMES = (("engine.jax_engine", "engine.torch_engine"), ("JaxEngine", "TorchEngine"))
CASES = load_cases(globals(), "test_parallel.py", renames=RENAMES,
                   only=("test_roofline_whole_generation_uses_mid_context",))
