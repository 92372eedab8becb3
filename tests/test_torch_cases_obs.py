"""The rest of the JAX package's ``tests/test_obs.py`` on the port's
``obs/`` and serving stack, loaded with the package name swapped:
counters, gauges, histograms and their exposition (the golden text
included), the registry and its snapshot, spans and their parent links
across threads, the kill switch over metrics, spans, the flight recorder,
the sampler and the SLO engine, ``/metrics`` and ``/debug/timeseries``
after a served request, the scheduler's span tree and energy, the paged
pool's and the engine's families, the budget-admission counter, the
access log, and the bucket quantiles. Their servers run the port's fake
backend and ``TorchEngine(device="cpu")`` (``engines_on_the_cpu``).
``tests/test_torch_obs_energy.py`` and ``tests/test_torch_profilers_trace.py``
load the file's two energy and two span-trace cases.

Left out: ``test_jax_trace_reports_none_when_start_failed`` and
``test_jax_trace_reports_dir_when_trace_written``, which drive the JAX
profiler's trace; the port's ``torch.profiler`` window is held by
``tests/test_torch_profilers_trace.py``
(``test_torch_trace_reports_none_when_start_failed``,
``test_torch_trace_writes_the_window``).
"""

from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (("engine.jax_engine", "engine.torch_engine"), ("JaxEngine", "TorchEngine"))
ONLY = (
    "test_counter_gauge_and_exposition",
    "test_histogram_buckets_are_cumulative",
    "test_registry_families_idempotent_and_kind_checked",
    "test_snapshot_shape",
    "test_exposition_golden_output",
    "test_exposition_help_escaping",
    "test_kill_switch_silences_metrics_and_spans",
    "test_span_parent_links_and_chrome_export",
    "test_attach_carries_parent_across_threads",
    "test_metrics_endpoint_after_served_request",
    "test_metrics_endpoint_404_when_disabled",
    "test_kill_switch_covers_flight_and_debug_surface",
    "test_request_through_scheduler_yields_span_tree_and_energy",
    "test_paged_pool_and_engine_families_in_exposition",
    "test_scheduler_budget_admission_counter",
    "test_kill_switch_keeps_serving_but_drops_telemetry",
    "test_access_log_opt_in",
    "test_access_log_default_off",
    "test_quantile_from_buckets_monotone_in_q",
    "test_quantile_from_buckets_exact_on_single_bucket_mass",
    "test_quantile_from_buckets_inf_and_edge_handling",
    "test_bucket_fraction_below_additive_across_merged_histograms",
    "test_debug_timeseries_endpoint_after_served_request",
    "test_kill_switch_keeps_sampler_and_slo_engine_off",
)
CASES = load_cases(globals(), "test_obs.py", renames=RENAMES, only=ONLY)
