"""The port's flight recorder, anomaly detection and live energy
attribution against the JAX package's.

The cases of ``tests/test_flight.py`` that need no served request and no
stepped session run on the port's ``obs/flight.py`` and ``obs/detect.py``
(the ring, crash dumps, Welford, the per-cell CV, spikes; the study's
``populate_run_data`` feeding ``CELL_CV``, with the JAX package's fake
backend as a stand-in that is never called). The two energy cases of
``tests/test_obs.py`` run on the port's ``obs/energy.py``. At the JAX
package's v5e constants the port's ``estimate_from_stats`` equals the JAX
one; at the H100's its corners come from ``profilers/nvml.py``'s box.
Last, ``TorchEngine(device="cpu").generate`` carries
``extras["energy_model"]``, equal to ``attribute_result`` on that result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.obs import energy as jax_energy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.profilers import tpu
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import obs
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs import energy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import nvml
from test_torch_runner import port_module, run_case
from test_torch_study import V5eModel
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

FLIGHT_CASES = (
    "test_ring_records_schema_and_order",
    "test_ring_drop_oldest_counts_dropped",
    "test_ring_filters_and_limits",
    "test_ring_concurrent_writers_no_tearing",
    "test_ring_export_jsonl",
    "test_ring_emit_noop_when_disabled",
    "test_crash_dump_writes_events_and_state",
    "test_crash_dump_never_raises",
    "test_welford_matches_statistics",
    "test_welford_cv_none_until_two_runs",
    "test_cell_cv_gauge_and_anomaly_once_per_breach",
    "test_cell_cv_rearm_after_recovery",
    "test_cell_cv_noop_when_disabled",
    "test_cell_cv_wired_through_study_run_data",
    "test_spike_detector_fires_with_exemplar",
    "test_spike_excluded_from_window",
    "test_spike_detector_quiet_before_min_samples",
    "test_spike_detector_noop_when_disabled",
)
OBS_ENERGY_CASES = (
    "test_energy_estimate_bounds_bracket_nominal",
    "test_energy_estimate_none_without_window",
)
FLIGHT = port_module("test_flight.py")
OBS = port_module("test_obs.py")


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.enable()
    yield
    (obs.enable if was else obs.disable)()


@pytest.fixture
def obs_off():
    was = obs.enabled()
    obs.disable()
    yield
    (obs.enable if was else obs.disable)()


@pytest.mark.parametrize("name", FLIGHT_CASES)
def test_jax_flight_case_on_the_port(name, request):
    assert FLIGHT.FLIGHT is obs.FLIGHT
    run_case(getattr(FLIGHT, name), request)


@pytest.mark.parametrize("name", OBS_ENERGY_CASES)
def test_jax_obs_energy_case_on_the_port(name, request):
    run_case(getattr(OBS, name), request)


STATS = (
    {"flops": 1e12, "bytes": 5e10, "vpu_ops": 1e9, "duration_s": 1.0, "generated_tokens": 100},
    {"flops": 3.1e12, "bytes": 2.07e11, "vpu_ops": 4e10, "duration_s": 4.5, "generated_tokens": 134},
    {"flops": 9e14, "bytes": 9e12, "vpu_ops": 0.0, "duration_s": 0.8, "generated_tokens": 667},
    {"flops": 2e9, "duration_s": 0.2, "generated_tokens": 0},
    {"duration_s": 0.0},
)


@pytest.mark.parametrize("n_chips", [1, 8])
@pytest.mark.parametrize("stats", STATS, ids=range(len(STATS)))
def test_estimate_equals_jax_at_the_v5e_constants(stats, n_chips, monkeypatch):
    monkeypatch.setattr(energy, "GpuEnergyModelProfiler", V5eModel)
    monkeypatch.setattr(energy, "H100_IDLE_W_BOUNDS", tpu.V5E_IDLE_W_BOUNDS)
    monkeypatch.setattr(energy, "H100_TENSOR_ACTIVE_W_BOUNDS", tpu.V5E_MXU_ACTIVE_W_BOUNDS)
    monkeypatch.setattr(energy, "H100_HBM_ACTIVE_W_BOUNDS", tpu.V5E_HBM_ACTIVE_W_BOUNDS)
    monkeypatch.setattr(energy, "H100_CUDA_CORE_ACTIVE_W_BOUNDS", tpu.V5E_VPU_ACTIVE_W_BOUNDS)
    got = energy.estimate_from_stats(dict(stats), n_chips=n_chips)
    assert got == jax_energy.estimate_from_stats(dict(stats), n_chips=n_chips)
    assert (got is None) == (not stats.get("duration_s"))


def test_estimate_corners_are_the_h100_box():
    stats = STATS[1]
    est = energy.estimate_from_stats(dict(stats))
    from types import SimpleNamespace

    ctx = SimpleNamespace(scratch={"generation_stats": dict(stats)})
    nominal = nvml.GpuEnergyModelProfiler().collect(ctx)
    low = nvml.GpuEnergyModelProfiler(
        idle_w=nvml.H100_IDLE_W_BOUNDS[0], tensor_active_w=nvml.H100_TENSOR_ACTIVE_W_BOUNDS[0],
        hbm_active_w=nvml.H100_HBM_ACTIVE_W_BOUNDS[0],
        cuda_core_active_w=nvml.H100_CUDA_CORE_ACTIVE_W_BOUNDS[0]).collect(ctx)
    assert est["J"] == nominal["energy_model_J"] and est["J_low"] == low["energy_model_J"]
    assert est["power_model_W"] == nominal["gpu_power_model_W"]
    assert est["util_est"] == nominal["gpu_util_est"]
    assert est["J_low"] < est["J"] < est["J_high"]


MODEL = "qwen2:1.5b"


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_generate_carries_the_energy_model(quantize, obs_on):
    jcfg = jax_config(MODEL).tiny(vocab_size=259)
    cfg = get_model_config(MODEL).tiny(vocab_size=259)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    eng = TorchEngine(registry={MODEL: cfg}, dtype=torch.float32, device="cpu", quantize=quantize)
    eng.install_model(MODEL, cfg, params_from_numpy(np_params, "cpu", torch.float32))
    before = energy.REQUEST_JPT._default.count
    result = eng.generate(GenerationRequest(MODEL, "In 10 words, tell me about rivers",
                                            max_new_tokens=12))
    assert result.generated_tokens >= 1
    est = result.extras["energy_model"]
    assert est == energy.attribute_result(cfg, result, quantize=quantize)
    assert est["J_low"] < est["J"] < est["J_high"] and est["J_per_token"] > 0
    assert energy.REQUEST_JPT._default.count == before + 1


def test_generate_without_telemetry_has_no_energy_model(obs_off):
    cfg = get_model_config(MODEL).tiny(vocab_size=259)
    eng = TorchEngine(registry={MODEL: cfg}, dtype=torch.float32, device="cpu")
    result = eng.generate(GenerationRequest(MODEL, "rivers", max_new_tokens=4))
    assert "energy_model" not in (result.extras or {})


def test_telemetry_never_fails_a_request(obs_on, monkeypatch):
    cfg = get_model_config(MODEL).tiny(vocab_size=259)
    eng = TorchEngine(registry={MODEL: cfg}, dtype=torch.float32, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("attribution failed")

    monkeypatch.setattr(energy, "attribute_result", broken)
    result = eng.generate(GenerationRequest(MODEL, "rivers", max_new_tokens=4))
    assert result.generated_tokens >= 1 and "energy_model" not in (result.extras or {})
