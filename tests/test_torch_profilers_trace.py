"""The port's last profilers on the CPU: NVML's duty cycle, the
``torch.profiler`` trace, the host span trace and the serial power meter.

- ``NvmlDutyCycleProfiler`` (``profilers/energy_probe.py``): the JAX
  package's duty-cycle case (``tests/test_profilers.py:447``) on the port,
  with its columns renamed (``gpu_duty_cycle_pct``); then the profiler
  against the fake ``libnvidia-ml`` of ``tests/test_torch_profilers.py``
  (``nvmlDeviceGetUtilizationRates`` through the ctypes binding): the
  mean duty, P = idle + duty · (peak − idle) at the energy model's H100
  envelope over the sampled span, fewer than two readings giving None, an
  unsupported or absent NVML making it unavailable; the probe's
  ``nvml_utilization`` channel; the study wires it when it reads.
- ``TorchTraceProfiler``: a trace of the window written under
  ``<run_dir>/torch_trace/`` naming the ops run in it, ``trace_dir`` only
  when written (a failed start or export gives None), as
  ``tests/test_aux.py``'s and ``tests/test_obs.py:480-515``'s jax trace
  cases require of ``JaxTraceProfiler``.
- ``SpanTraceProfiler`` and ``SerialPowerMeterProfiler``: the cases of
  ``tests/test_obs.py:516-549`` and ``tests/test_serial_power.py`` on the
  port's copies.
"""

import csv
import json
import time

import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import obs, profilers
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import energy_probe, nvml
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers.torch_trace import TorchTraceProfiler
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.context import RunContext
from test_torch_profilers import BUS_ID, fake_nvml  # noqa: F401 — the fixture
from test_torch_runner import load_cases, port_module, run_case
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

DUTY = port_module("test_profilers.py", renames=(
    ("TpuDutyCycleProfiler", "NvmlDutyCycleProfiler"),
    ("tpu_duty_cycle_pct", "gpu_duty_cycle_pct"),
    ("tpu_duty_cycle.csv", "gpu_duty_cycle.csv"),
))
OBS = port_module("test_obs.py")
SPAN_CASES = ("test_span_trace_profiler_writes_artifact", "test_span_trace_profiler_none_without_spans")
SERIAL_CASES = load_cases(globals(), "test_serial_power.py")


def test_every_serial_case_is_loaded():
    assert sorted(SERIAL_CASES) == ["test_parse_wattsup_frames", "test_profiler_graceful_without_reader",
                                    "test_profiler_integrates_fake_meter"]


def _ctx(tmp_path) -> RunContext:
    run_dir = tmp_path / "run_0"
    run_dir.mkdir(parents=True, exist_ok=True)
    return RunContext(run_id="run_0", run_nr=1, total_runs=1, variation={},
                      run_dir=run_dir, experiment_dir=tmp_path)


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.enable()
    yield
    (obs.enable if was else obs.disable)()


# -- the duty cycle --------------------------------------------------------------
def test_jax_duty_cycle_case_on_the_port(request):
    run_case(DUTY.test_duty_cycle_profiler_summarises_trace, request)


def test_duty_profiler_reads_the_fake_card(tmp_path, fake_nvml):
    set_state = fake_nvml
    set_state(0, 100_000, util=40)
    prof = energy_probe.NvmlDutyCycleProfiler(period_s=0.01)
    assert prof.available and prof.measured_channel
    assert (prof.idle_w, prof.peak_w) == (nvml.H100_IDLE_W, nvml.H100_PEAK_W)
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    time.sleep(0.05)
    set_state(0, 100_000, util=80)
    time.sleep(0.05)
    prof.on_stop(ctx)
    out = prof.collect(ctx)
    with (ctx.run_dir / "gpu_duty_cycle.csv").open() as f:
        rows = list(csv.DictReader(f))
    duties = [float(r["duty_pct"]) for r in rows]
    assert set(duties) == {40.0, 80.0} and {r["n_chips"] for r in rows} == {"1"}
    mean = sum(duties) / len(duties)
    span = float(rows[-1]["t_s"]) - float(rows[0]["t_s"])
    assert out["gpu_duty_cycle_pct"] == round(mean, 2)
    watts = nvml.H100_IDLE_W + mean / 100 * (nvml.H100_PEAK_W - nvml.H100_IDLE_W)
    assert out["energy_duty_J"] == pytest.approx(watts * span, abs=1e-3)


def test_duty_profiler_one_reading_gives_none(tmp_path):
    class Card:
        def utilization_pct(self):
            return 55

    prof = energy_probe.NvmlDutyCycleProfiler(period_s=60.0, source=Card())
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    prof.on_stop(ctx)  # only the final reading lands
    assert prof.collect(ctx) == {"gpu_duty_cycle_pct": None, "energy_duty_J": None}


@pytest.mark.parametrize("why", ["no library", "utilization unsupported", "wrong bus id"])
def test_duty_profiler_unavailable_degrades_to_none(tmp_path, fake_nvml, monkeypatch, why):
    set_state = fake_nvml
    set_state(0, 100_000, util=50, util_supported=0 if why == "utilization unsupported" else 1)
    if why == "no library":
        monkeypatch.setattr(nvml, "NVML_LIB", str(tmp_path / "absent.so"))
    if why == "wrong bus id":
        monkeypatch.setattr(nvml, "cuda_pci_bus_id", lambda: "00000000:99:00.0")
    prof = energy_probe.NvmlDutyCycleProfiler(period_s=0.01)
    assert not prof.available and prof.unavailable_reason
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    time.sleep(0.03)
    prof.on_stop(ctx)
    assert prof.collect(ctx) == {"gpu_duty_cycle_pct": None, "energy_duty_J": None}


def test_probe_reports_the_utilization_channel(fake_nvml, tmp_path, monkeypatch):
    set_state = fake_nvml
    set_state(0, 100_000, util=37)
    live = energy_probe._probe_nvml_utilization()
    assert (live.name, live.kind, live.scope, live.available) == (
        "nvml_utilization", "utilization", "device", True)
    assert "duty cycle 37%" in live.detail
    set_state(0, 100_000, util_supported=0)
    assert not energy_probe._probe_nvml_utilization().available
    monkeypatch.setattr(nvml, "NVML_LIB", str(tmp_path / "absent.so"))
    assert "cannot load" in energy_probe._probe_nvml_utilization().detail


def test_the_study_wires_the_duty_profiler_when_it_reads(fake_nvml, tmp_path):
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import LlmEnergyConfig
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.validation import validate_config

    set_state = fake_nvml
    set_state(1000, 100_000, util=10)
    config = LlmEnergyConfig(results_output_path=tmp_path)
    kinds = [type(p).__name__ for p in config.profilers]
    assert kinds[:2] == ["NvmlDutyCycleProfiler", "NvmlEnergyProfiler"], kinds
    config.profilers.append(TorchTraceProfiler())
    validate_config(config)  # the runner's check takes every profiler
    client = LlmEnergyConfig(on_device_url="http://127.0.0.1:1")
    assert not any(isinstance(p, energy_probe.NvmlDutyCycleProfiler) for p in client.profilers)
    set_state(1000, 100_000, util_supported=0)
    assert not any(isinstance(p, energy_probe.NvmlDutyCycleProfiler)
                   for p in LlmEnergyConfig().profilers)


# -- the torch.profiler trace ----------------------------------------------------
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def test_torch_trace_writes_the_window(tmp_path):
    ctx = _ctx(tmp_path)
    prof = TorchTraceProfiler(activities=CPU_ONLY)
    prof.on_start(ctx)
    _ = torch.ones((8, 8)) @ torch.ones((8, 8))
    prof.on_stop(ctx)
    data = prof.collect(ctx)
    assert data["trace_dir"].endswith("torch_trace")
    events = json.loads((ctx.run_dir / "torch_trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_torch_trace_reports_none_when_start_failed(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("no profiler backend")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    prof = TorchTraceProfiler(activities=CPU_ONLY)
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    prof.on_stop(ctx)
    assert prof.collect(ctx) == {"trace_dir": None}
    assert not (ctx.run_dir / "torch_trace").exists()


def test_torch_trace_reports_none_when_export_failed(tmp_path, monkeypatch):
    prof = TorchTraceProfiler(activities=CPU_ONLY)
    ctx = _ctx(tmp_path)
    prof.on_start(ctx)
    monkeypatch.setattr(prof._prof, "export_chrome_trace", lambda path: (_ for _ in ()).throw(OSError("full")))
    prof.on_stop(ctx)
    assert prof.collect(ctx) == {"trace_dir": None}


def test_torch_trace_is_opt_in():
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments.llm_energy import LlmEnergyConfig

    assert not any(isinstance(p, TorchTraceProfiler) for p in LlmEnergyConfig().profilers)
    assert TorchTraceProfiler().activities is None  # CPU, and CUDA where a card is


def test_the_package_exports_the_new_profilers():
    for name in ("NvmlDutyCycleProfiler", "TorchTraceProfiler", "SpanTraceProfiler", "SerialPowerMeterProfiler"):
        assert name in profilers.__all__ and hasattr(profilers, name)


# -- the span trace --------------------------------------------------------------
@pytest.mark.parametrize("name", SPAN_CASES)
def test_jax_span_trace_case_on_the_port(name, request):
    run_case(getattr(OBS, name), request)
