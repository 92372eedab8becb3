"""The port's profilers: the JAX package's framework-free profiler cases,
NVML against a fake library, and the GPU energy model.

The framework-free cases of ``tests/test_profilers.py`` run on the port,
loaded with the JAX package's name replaced by the port's. The NVML
profiler and probe are driven through a fake ``libnvidia-ml`` built with
g++ into the test's temporary directory (so the ctypes binding itself is
exercised), and through an injected source. The GPU energy model, given
the JAX model's v5e constants, must give the TPU model's columns exactly;
its own H100 constants and its clamp are pinned.
"""

import inspect
import subprocess
import time

import pytest

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
    GenerationResult as JaxResult,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.experiments.llm_energy import (
    generation_stats_from as jax_stats_from,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.profilers import tpu
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import nvml
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers.energy_probe import (
    _probe_nvml,
    probe_energy_channels,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.context import RunContext
from test_torch_runner import port_module

# The framework-free cases of tests/test_profilers.py (integration,
# synthetic, host, RAPL, the probe report, sysfs power).
JAX_CASES = (
    "test_integrate_constant_power",
    "test_integrate_handles_missing_and_short",
    "test_synthetic_profiler_energy_close_to_expected",
    "test_sampling_profiler_final_sample_even_for_short_window",
    "test_host_profiler_reports_cpu_and_memory",
    "test_rapl_profiler_graceful_without_counters",
    "test_rapl_profiler_reads_fake_counters",
    "test_rapl_wraparound_corrected",
    "test_write_probe_report",
    "test_sysfs_profiler_reads_hwmon_rails",
    "test_sysfs_battery_on_ac_is_not_a_measured_channel",
    "test_sysfs_profiler_battery_fallbacks",
    "test_sysfs_profiler_unavailable_degrades",
    "test_study_wires_sysfs_profiler_when_available",
    "test_hwmon_package_rail_selected_by_numeric_index",
)


PORT_CASES = port_module("test_profilers.py")


@pytest.mark.parametrize("name", JAX_CASES)
def test_jax_profiler_case_on_the_port(name, request):
    fn = getattr(PORT_CASES, name)
    assert fn.__globals__["RunContext"] is RunContext
    fn(**{p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters})


def _ctx(tmp_path) -> RunContext:
    run_dir = tmp_path / "run_0"
    run_dir.mkdir(parents=True, exist_ok=True)
    return RunContext(run_id="run_0", run_nr=1, total_runs=1, variation={},
                      run_dir=run_dir, experiment_dir=tmp_path)


def test_probe_covers_host_channels_and_nvml():
    statuses = probe_energy_channels()
    assert [s.name for s in statuses] == ["rapl", "hwmon", "battery", "nvml", "nvml_utilization"]
    for s in statuses:
        assert s.kind in (("utilization",) if s.name == "nvml_utilization" else ("energy", "power"))
        assert s.scope in ("host", "device")
        assert s.detail
    skipped = probe_energy_channels(include_device=False)[-2:]
    assert [(s.name, s.available) for s in skipped] == [("nvml", False), ("nvml_utilization", False)]
    assert all("skipped" in s.detail for s in skipped)


# -- NVML through a fake libnvidia-ml ----------------------------------------

BUS_ID = "00000000:18:00.0"
FAKE_NVML = r"""
#include <cstring>
extern "C" {
static unsigned long long energy_mj = 0;
static unsigned power_mw = 0;
static int energy_supported = 1;
static unsigned util_gpu = 0;
static int util_supported = 1;
static int initialised = 0;
static int dev;
void fake_set(unsigned long long e, unsigned p, int supported, unsigned util, int util_ok) {
    energy_mj = e; power_mw = p; energy_supported = supported;
    util_gpu = util; util_supported = util_ok;
}
struct Utilization { unsigned gpu; unsigned memory; };
int nvmlDeviceGetUtilizationRates(void* h, Utilization* u) {
    if (h != &dev) return 6;
    if (!util_supported) return 3;
    u->gpu = util_gpu; u->memory = util_gpu / 2; return 0;
}
const char* nvmlErrorString(int rc) {
    return rc == 3 ? "Not Supported" : rc == 6 ? "Not Found" : "Uninitialized";
}
int nvmlInit_v2() { initialised = 1; return 0; }
int nvmlDeviceGetCount_v2(unsigned* n) { *n = 1; return initialised ? 0 : 1; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void** h) {
    if (i != 0) return 6;
    *h = &dev; return 0;
}
int nvmlDeviceGetHandleByPciBusId_v2(const char* bus, void** h) {
    if (std::strcmp(bus, "00000000:18:00.0") != 0) return 6;
    *h = &dev; return 0;
}
int nvmlDeviceGetTotalEnergyConsumption(void* h, unsigned long long* e) {
    if (h != &dev) return 6;
    if (!energy_supported) return 3;
    *e = energy_mj; return 0;
}
int nvmlDeviceGetPowerUsage(void* h, unsigned* p) { *p = power_mw; return h == &dev ? 0 : 6; }
int nvmlDeviceGetEnforcedPowerLimit(void* h, unsigned* p) { *p = 700000; return h == &dev ? 0 : 6; }
int nvmlDeviceGetName(void* h, char* name, unsigned len) {
    std::strncpy(name, "Fake H100 80GB HBM3", len); return h == &dev ? 0 : 6;
}
}
"""


@pytest.fixture
def fake_nvml(tmp_path, monkeypatch):
    """The fake library's setter (energy mJ, power mW, the counter's
    support, the utilization's percent and support); ``nvml.NVML_LIB``
    points at the fake and the current CUDA device is the fake's, at
    ``BUS_ID``."""
    src = tmp_path / "fake_nvml.cpp"
    src.write_text(FAKE_NVML)
    lib = tmp_path / "libfake_nvml.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=120)
    import ctypes

    handle = ctypes.CDLL(str(lib))
    handle.fake_set.argtypes = [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_int]

    def set_state(energy_mj, power_mw, supported=1, util=0, util_supported=1):
        handle.fake_set(energy_mj, power_mw, supported, util, util_supported)

    monkeypatch.setattr(nvml, "NVML_LIB", str(lib))
    monkeypatch.setattr(nvml, "cuda_pci_bus_id", lambda: BUS_ID)
    return set_state


def test_nvml_profiler_reads_the_energy_counter_and_power(tmp_path, fake_nvml):
    set_state = fake_nvml
    set_state(5000, 150_000)
    prof = nvml.NvmlEnergyProfiler(period_s=0.01)
    assert prof.available and prof.measured_channel
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    set_state(12_500, 150_000)  # +7.5 J over the window
    time.sleep(0.06)
    prof.on_stop(ctx)
    out = prof.collect(ctx)
    assert out == {"gpu_energy_J": 7.5, "gpu_avg_power_W": 150.0}
    assert (ctx.run_dir / "gpu_power.csv").exists()
    dev = nvml.nvml_device()
    assert (dev.name(), dev.power_limit_w(), dev.power_w()) == ("Fake H100 80GB HBM3", 700.0, 150.0)


@pytest.mark.parametrize("why", ["no library", "wrong bus id", "counter unsupported"])
def test_nvml_profiler_unavailable_degrades_to_none(tmp_path, fake_nvml, monkeypatch, why):
    set_state = fake_nvml
    set_state(1000, 90_000, supported=0 if why == "counter unsupported" else 1)
    if why == "wrong bus id":
        monkeypatch.setattr(nvml, "cuda_pci_bus_id", lambda: "00000000:99:00.0")
    if why == "no library":
        monkeypatch.setattr(nvml, "NVML_LIB", str(tmp_path / "absent.so"))
    prof = nvml.NvmlEnergyProfiler(period_s=0.01)
    assert not prof.available
    assert prof.unavailable_reason
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    prof.on_stop(ctx)
    assert prof.collect(ctx) == {"gpu_energy_J": None, "gpu_avg_power_W": None}


def test_nvml_probe_reports_count_counter_and_power_limit(fake_nvml, tmp_path, monkeypatch):
    set_state = fake_nvml
    set_state(1000, 90_000)
    live = _probe_nvml()
    assert (live.name, live.kind, live.scope, live.available) == ("nvml", "energy", "device", True)
    assert "1 device(s)" in live.detail and "Fake H100 80GB HBM3" in live.detail
    assert "energy counter supported" in live.detail and "power limit 700.00 W" in live.detail
    set_state(1000, 90_000, supported=0)
    assert not _probe_nvml().available
    monkeypatch.setattr(nvml, "NVML_LIB", str(tmp_path / "absent.so"))
    absent = _probe_nvml()
    assert not absent.available and "cannot load" in absent.detail


def test_nvml_injected_source_both_directions(tmp_path):
    class Source:
        def __init__(self, energy):
            self.energy = energy

        def total_energy_mj(self):
            if self.energy is None:
                raise nvml.NvmlError("Not Supported")
            return self.energy

        def power_w(self):
            return 80.0

    src = Source(2000)
    live = nvml.NvmlEnergyProfiler(period_s=0.01, source=src)
    assert live.available
    ctx = _ctx(tmp_path)
    live.on_start(ctx)
    src.energy = 2250
    time.sleep(0.04)
    live.on_stop(ctx)
    assert live.collect(ctx) == {"gpu_energy_J": 0.25, "gpu_avg_power_W": 80.0}
    dead = nvml.NvmlEnergyProfiler(period_s=0.01, source=Source(None))
    assert not dead.available


def test_pci_bus_id_in_nvml_form():
    assert nvml.format_pci_bus_id(0, 0x18, 0) == BUS_ID
    assert nvml.format_pci_bus_id(1, 0xAB, 0x1F) == "00000001:ab:1f.0"


# -- the GPU energy model -----------------------------------------------------

V5E_KW = dict(peak_tflops=tpu.V5E_PEAK_BF16_TFLOPS, peak_w=tpu.V5E_PEAK_W, idle_w=tpu.V5E_IDLE_W,
              spec_hbm_gbps=tpu.V5E_SPEC_HBM_GBPS)
GPU_V5E = dict(V5E_KW, cuda_core_ops_per_s=tpu.V5E_VPU_OPS_PER_S, tensor_active_w=tpu.V5E_MXU_ACTIVE_W,
               hbm_active_w=tpu.V5E_HBM_ACTIVE_W, cuda_core_active_w=tpu.V5E_VPU_ACTIVE_W)
COLUMNS = {"energy_model_J": "energy_model_J", "joules_per_token": "joules_per_token",
           "gpu_util_est": "tpu_util_est", "gpu_power_model_W": "tpu_power_model_W"}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
@pytest.mark.parametrize("n_chips", [1, 8])
def test_gpu_model_with_v5e_constants_equals_the_tpu_model(tmp_path, quantize, n_chips):
    cfg = jax_config("llama3.1:8b")
    for decode_s in (0.05, 2.7, 40.0):  # from saturated duties to idle-like
        result = JaxResult(request=JaxRequest("llama3.1:8b", "x", 134), tokens=[1] * 134, text="",
                           prompt_tokens=57, generated_tokens=134, prefill_s=0.02,
                           decode_s=decode_s, total_s=decode_s + 0.02)
        stats = jax_stats_from(cfg, result, quantize=quantize, n_chips=n_chips)
        ctx = _ctx(tmp_path)
        ctx.scratch["generation_stats"] = stats
        gpu = nvml.GpuEnergyModelProfiler(n_chips=n_chips, **GPU_V5E).collect(ctx)
        want = tpu.TpuEnergyModelProfiler(
            n_chips=n_chips, vpu_ops_per_s=tpu.V5E_VPU_OPS_PER_S, mxu_active_w=tpu.V5E_MXU_ACTIVE_W,
            hbm_active_w=tpu.V5E_HBM_ACTIVE_W, vpu_active_w=tpu.V5E_VPU_ACTIVE_W, **V5E_KW,
        ).collect(ctx)
        assert {COLUMNS[k]: v for k, v in gpu.items()} == want, (quantize, decode_s)


def test_gpu_model_constants_are_the_h100_data_sheet_and_the_modelled_watts():
    # data sheet (H100 SXM): 989 TFLOP/s dense bf16, 3.35 TB/s, 700 W,
    # 67 TFLOP/s FP32 on the CUDA cores
    assert nvml.H100_PEAK_BF16_TFLOPS == 989.0
    assert nvml.H100_SPEC_HBM_GBPS == 3350.0
    assert nvml.H100_PEAK_W == 700.0
    assert nvml.H100_CUDA_CORE_OPS_PER_S == 67.0e12
    # modelled and uncalibrated, each inside the bound its derivation
    # states (the card's NVML idle reading lies above the idle bound:
    # profilers/nvml.py says so beside the constant)
    for value, (lo, hi) in (
        (nvml.H100_IDLE_W, nvml.H100_IDLE_W_BOUNDS),
        (nvml.H100_TENSOR_ACTIVE_W, nvml.H100_TENSOR_ACTIVE_W_BOUNDS),
        (nvml.H100_HBM_ACTIVE_W, nvml.H100_HBM_ACTIVE_W_BOUNDS),
        (nvml.H100_CUDA_CORE_ACTIVE_W, nvml.H100_CUDA_CORE_ACTIVE_W_BOUNDS),
    ):
        assert lo <= value <= hi
    assert (nvml.H100_IDLE_W, nvml.H100_TENSOR_ACTIVE_W, nvml.H100_HBM_ACTIVE_W,
            nvml.H100_CUDA_CORE_ACTIVE_W) == (70.0, 630.0, 200.0, 200.0)
    # idle + full tensor duty is the card's limit by construction
    assert nvml.H100_IDLE_W + nvml.H100_TENSOR_ACTIVE_W == nvml.H100_PEAK_W


def test_gpu_model_power_states_and_clamp(tmp_path):
    prof = nvml.GpuEnergyModelProfiler()
    ctx = _ctx(tmp_path)
    assert prof.collect(ctx) == dict.fromkeys(prof.data_columns)
    states = [
        ({"flops": 0.0}, 70.0, 0.0),  # idle
        ({"flops": 989e12 * 2.0}, 700.0, 1.0),  # tensor cores saturated
        ({"bytes": 3350e9 * 2.0}, 270.0, 1.0),  # memory stream saturated
        ({"vpu_ops": 67e12 * 2.0}, 270.0, 1.0),  # CUDA cores saturated
        ({"flops": 989e12 * 2.0, "bytes": 3350e9 * 2.0, "vpu_ops": 67e12 * 2.0}, 700.0, 1.0),  # clamp
        ({"bytes": 3350e9 * 20.0}, 270.0, 1.0),  # a duty above 1 is capped
    ]
    for extra, watts, util in states:
        ctx.scratch["generation_stats"] = dict(extra, duration_s=2.0, generated_tokens=10)
        out = prof.collect(ctx)
        assert out["gpu_power_model_W"] == watts and out["gpu_util_est"] == util, extra
        assert out["energy_model_J"] == watts * 2.0
        assert out["joules_per_token"] == watts * 2.0 / 10
    prof.n_chips = 8  # the study's remote rows
    ctx.scratch["generation_stats"] = {"flops": 0.0, "duration_s": 2.0, "generated_tokens": 4}
    assert prof.collect(ctx)["energy_model_J"] == 70.0 * 8 * 2.0
