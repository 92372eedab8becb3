"""The framework-free cases of the JAX package's ``tests/test_transformer.py``
on the port's ``models/``, loaded with the package name swapped: the
registry covers the reference sweep, parameter counts are near the
models' names, an unknown model raises, and the byte tokenizer round
trips.

The other five run the JAX forward on JAX arrays (shapes and the cache
update, incremental decode and chunked prefill against a full prefill,
every family variant, per-sequence offsets); the port's forward is held
against the JAX one on the same bridged weights and inputs in
``tests/test_torch_transformer.py::test_prefill_and_decode_match_jax``
(every family, prefill then decode steps, plain, int8 weights and int8
KV) and ``test_stacked_paged_decode_matches_jax``, and its chunked and
per-row-offset prefill in ``tests/test_torch_batch_engine.py``.
"""

from test_torch_runner import load_cases

ONLY = (
    "test_registry_covers_the_reference_sweep",
    "test_param_counts_near_nameplate",
    "test_unknown_model_raises",
    "test_tokenizer_round_trip",
)
CASES = load_cases(globals(), "test_transformer.py", only=ONLY)
