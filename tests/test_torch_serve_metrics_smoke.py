"""The port's serving smoke, ``scripts/torch_serve_metrics_smoke.py``, run
as a subprocess with ``jax`` and the JAX package blocked: it must end
``status: ok``, write its three positional outputs, and report the JAX
script's counters. ``JAX_COUNTERS`` holds the counters of
``scripts/serve_metrics_smoke.py``'s status line that do not depend on
thread timing (two runs of the JAX script on the CPU gave them alike);
trace ids, seconds, slice counts, the retry's Joules, swap bytes and the
SLO attainment are left out."""

import json
import os
import pathlib
import subprocess
import sys

from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_serve_metrics_smoke.py"
TIMEOUT_S = 300
BLOCKED = ("jax", "jaxlib", "cain_2025_device_remote_llm_energy_rep_pkg_tpu")

JAX_COUNTERS = {
    "status": "ok",
    "metric_families": 17,
    "continuous": {"rows_joined": 2.0, "rows_retired": 3.0},
    "chunked_join": {"rows_joined": 1.0, "join_chunks": 5.0},
    "streaming_cancellation": {"rows_cancelled": 1.0},
    "shared_prefix": {"hit_tokens": 45.0, "prefix_hit_events": 1},
    "tp_continuous": {"mesh": {"devices": 2, "axes": {"tp": 2}, "platform": "cpu"}, "sessions_opened": 1.0,
                      "rows_retired": 2.0},
    "speculative": {"fallbacks_at_zero_acceptance": 1.0},
    "preemption": {"parked_mid_flight": 1, "victim_completed_tokens": 160},
    "router_fleet": {"dispatch_split": {"r0": 2.0, "r1": 2.0}, "retries_after_kill": 1.0,
                     "accepted_stream_tokens_after_kill": 160, "replica_down_events": 1, "drained": True},
    "fleet_obs": {"dispatch_attempts": 2, "fleet_requests_total": 60.0},
    "prefix_store": {"cross_session_hits": 1, "spill_events": 6, "restore_events": 2},
    "model_fleet": {"small_retired_before_big": True, "escalation_wasted_joules": 5.5, "escalated_events": 1,
                    "ps_after_eviction": ["small:1b"]},
    "spec_sampled": {"cross_rounds": 64.0, "cross_rejected_tokens": 112.0, "cross_fallbacks": 1.0,
                     "draft_wasted_joules": 11.2, "wire_agrees": True},
    "slo": {"window_delta_matches_scrape": True, "fired": "slo-completion_p95_s-1",
            "resolved": "slo-completion_p95_s-1", "replica_recompute_agrees": True},
    "pd_disagg": {"roles": {"prefill": 1, "decode": 1}, "streamed_tokens_from_decode": 64,
                  "migrate_bytes_moved": 738304.0, "bytes_symmetric": True, "wasted_migration_joules": 0.001476608,
                  "wire_ledger_agrees": True},
    "affinity_admission": {"affinity_hits": 1.0, "est_tokens": 96, "full_replica_dispatches": 0.0,
                           "refused_retries": 0.0, "occupant_tokens": 640, "headroom_recovered": 8},
    "tenant_accounting": {"acme_joules": 4.0, "table_agrees_by_hand": True, "beta_cancelled": 1,
                          "ledger_records": 4, "ledger_seq_monotonic": True, "fleet_tenant_joules": 6.4,
                          "fleet_equals_merged_scrapes": True, "kill_switch_404": True},
}


def _pick(status, want):
    """``status`` cut to the keys of ``want``, nested dicts alike."""
    return {k: _pick(status.get(k, {}), v) if isinstance(v, dict) and k != "axes" else status.get(k)
            for k, v in want.items()}


def test_the_port_serving_smoke_reports_the_jax_scripts_counters(tmp_path):
    outs = [tmp_path / n for n in ("trace.json", "flight.json", "timeseries.json")]
    code = (
        "import runpy, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = [{str(SCRIPT)!r}, *{[str(p) for p in outs]!r}]\n"
        f"runpy.run_path({str(SCRIPT)!r}, run_name='__main__')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=TIMEOUT_S,
                          cwd=tmp_path, env=env)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    status = json.loads(proc.stdout.strip().splitlines()[-1])
    assert _pick(status, JAX_COUNTERS) == JAX_COUNTERS
    assert status["trace"] == str(outs[0]) and status["flight"]["dump"] == str(outs[1])
    assert status["slo"]["timeseries_dump"] == str(outs[2])
    for path in outs:
        assert json.loads(path.read_text())
