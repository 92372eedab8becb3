"""The framework-free cases of the JAX package's ``tests/test_aux.py`` that
no other port module holds, loaded with the package name swapped: the
distributed config read from the env and from ``.env`` (absent and
present), ``analyze`` over a run table, and the native and Python host
profilers offering one column set.

Its checkpoint and weight-cache cases have port twins in
``tests/test_torch_checkpoint.py``: ``test_params_checkpoint_round_trip``,
``test_weight_cache_initialises_once`` and ``test_engine_uses_weight_cache``
by the same names, ``test_weight_cache_keyed_by_config_and_dtype`` as
``test_weight_cache_keyed_by_config_dtype_and_mode``. Its JAX profiler
trace case, ``test_jax_trace_profiler_graceful``, has the port's
``torch.profiler`` window as its twin
(``tests/test_torch_profilers_trace.py::test_torch_trace_writes_the_window``).
"""

from test_torch_runner import load_cases

ONLY = (
    "test_distributed_config_absent",
    "test_distributed_config_from_dotenv",
    "test_analyze_cli",
    "test_host_profiler_columns_stable_across_implementations",
)
CASES = load_cases(globals(), "test_aux.py", only=ONLY)
