"""The study on the port against the study on the JAX package.

The byte model (``utils/memory.py``) and ``generation_stats_from`` must
equal the JAX package's exactly for the 7 study models, every weight mode
and both KV modes; for the aliased ``remote`` row the port's roofline is
patched with the JAX package's TPU constants, which makes the two
formulas the same formula. Then the study config runs end to end in both
packages on one tiny qwen2 in f32 (int8 weights, both locations, a
10-word length, 2 repetitions): ``LlmEnergyConfig`` over ``JaxEngine`` and
over ``TorchEngine(device="cpu")`` with the same weights
(``models/bridge.py``), and the rows and generated texts must agree.
"""

import csv
import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
    GenerationResult as JaxResult,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.experiments import llm_energy as jax_study
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import roofline as jax_roofline
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.profilers import tpu
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.runner.controller import (
    ExperimentController as JaxController,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.utils import compile_cache
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.utils import memory as jax_memory
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
    GenerationResult,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.experiments import llm_energy as study
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel import roofline
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import nvml
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.controller import (
    ExperimentController,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.context import RunContext
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.utils import memory
from test_torch_runner import port_module, run_case
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

QUANT = [None, "int8", "int4", "int4-i32"]
CONTEXTS = (1, 57, 190, 2111)
BYTE_FUNCTIONS = ("estimate_weight_bytes", "decode_weight_stream_bytes",
                  "decode_vpu_unpack_ops_per_step")


def test_the_study_models_are_the_jax_study_models():
    assert study.MODELS == jax_study.MODELS and len(study.MODELS) == 7
    assert (study.LOCATIONS, study.LENGTHS, study.TOKENS_PER_WORD) == (
        jax_study.LOCATIONS, jax_study.LENGTHS, jax_study.TOKENS_PER_WORD)
    assert study.DEFAULT_N_CHIPS_BY_LOCATION == jax_study.DEFAULT_N_CHIPS_BY_LOCATION
    assert memory.VPU_UNPACK_OPS_PER_BYTE == jax_memory.VPU_UNPACK_OPS_PER_BYTE


@pytest.mark.parametrize("quantize", QUANT)
@pytest.mark.parametrize("model", jax_study.MODELS)
def test_byte_model_equals_jax(model, quantize):
    cfg, jcfg = get_model_config(model), jax_config(model)
    for name in BYTE_FUNCTIONS:
        assert getattr(memory, name)(cfg, quantize) == getattr(jax_memory, name)(jcfg, quantize), name
    for kv in (None, "int8"):
        for t in CONTEXTS:
            assert memory.decode_kv_stream_bytes(cfg, t, kv_quantize=kv) == (
                jax_memory.decode_kv_stream_bytes(jcfg, t, kv_quantize=kv))
            assert memory.estimate_decode_read_bytes_per_step(cfg, quantize, t, kv_quantize=kv) == (
                jax_memory.estimate_decode_read_bytes_per_step(jcfg, quantize, t, kv_quantize=kv))


def _results(model, prompt, generated, decode_s):
    req = dict(model=model, prompt="x", max_new_tokens=134)
    res = dict(tokens=[1] * generated, text="", prompt_tokens=prompt, generated_tokens=generated,
               prefill_s=0.03, decode_s=decode_s, total_s=decode_s + 0.03)
    return (GenerationResult(request=GenerationRequest(**req), **res),
            JaxResult(request=JaxRequest(**req), **res))


@pytest.mark.parametrize("quantize", QUANT)
@pytest.mark.parametrize("model", jax_study.MODELS)
def test_generation_stats_equal_jax(model, quantize, monkeypatch):
    cfg, jcfg = get_model_config(model), jax_config(model)
    # the TPU constants make the port's roofline the JAX one
    monkeypatch.setattr(roofline, "SUSTAINED_HBM_GBPS", jax_roofline.V5E_SUSTAINED_HBM_GBPS)
    monkeypatch.setattr(roofline, "NVLINK_GBPS", jax_roofline.ICI_LINK_GBPS)
    monkeypatch.setattr(roofline, "NVLINK_HOP_LATENCY_S", jax_roofline.ICI_HOP_LATENCY_S)
    for prompt, generated, decode_s in ((57, 134, 2.5), (61, 667, 13.0), (2112, 1, 0.01), (40, 0, 0.0)):
        port_res, jax_res = _results(model, prompt, generated, decode_s)
        for kv in (None, "int8"):
            for n_chips, aliased in ((1, False), (8, False), (8, True), (3, True)):
                kw = dict(quantize=quantize, kv_quantize=kv, n_chips=n_chips, aliased=aliased)
                got = study.generation_stats_from(cfg, port_res, **kw)
                assert got == jax_study.generation_stats_from(jcfg, jax_res, **kw), kw
                assert ("modeled_decode_s" in got) == (aliased and decode_s > 0 and generated > 0)
    assert study.generation_stats_from(None, port_res) == jax_study.generation_stats_from(None, jax_res)


def test_h100_roofline_constants():
    # data sheet (H100 SXM): 3.35 TB/s HBM3, 900 GB/s NVLink both ways
    assert (roofline.SUSTAINED_HBM_GBPS, roofline.NVLINK_GBPS) == (3350.0, 450.0)
    lo, hi = roofline.NVLINK_HOP_LATENCY_S_BOUNDS  # modelled
    assert lo <= roofline.NVLINK_HOP_LATENCY_S == 1.5e-6 <= hi
    assert roofline.allreduce_cost_s(0.0, 8) == 14 * 1.5e-6
    assert roofline.allreduce_cost_s(1e6, 1) == 0.0


def test_h100_roofline_bills_the_node_faster_than_one_card():
    cfg = get_model_config("llama3.1:8b")
    port_res, _ = _results("llama3.1:8b", 57, 134, 6.0)
    stats = study.generation_stats_from(cfg, port_res, quantize="int8", n_chips=8, aliased=True)
    assert 0 < stats["modeled_decode_s"] < 6.0
    assert stats["duration_s"] == 6.0 * (
        roofline.modeled_tp_decode_s(cfg, "int8", 8, 57, 134)
        / roofline.modeled_tp_decode_s(cfg, "int8", 1, 57, 134))


# -- the tiny study through both packages --------------------------------------

MODEL = "qwen2:1.5b"  # its tiny() twin is installed under the study's name
SHARED = dict(models=[MODEL], locations=["on_device", "remote"], lengths=[10], repetitions=2,
              cooldown_ms=0, seed=3, quantize="int8")


def _run(config_cls, controller, engine, out: Path):
    cfg = config_cls(results_output_path=out, backends={"on_device": engine, "remote": engine}, **SHARED)
    controller(cfg, echo=False).do_experiment()
    exp = out / cfg.name
    with (exp / "run_table.csv").open() as f:
        rows = list(csv.DictReader(f))
    texts = {r["__run_id"]: (exp / r["__run_id"] / "generation.txt").read_text() for r in rows}
    return rows, texts


def test_tiny_study_gives_the_same_rows_through_both_packages(tmp_path, monkeypatch):
    # the JAX study points JAX's compile cache under the home directory;
    # the tests keep theirs
    monkeypatch.setattr(compile_cache, "enable_compilation_cache", lambda *a, **k: None)
    jcfg = jax_config(MODEL).tiny(vocab_size=259)
    pcfg = get_model_config(MODEL).tiny(vocab_size=259)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(5), jnp.float32))
    jeng = JaxEngine(registry={MODEL: jcfg}, dtype=jnp.float32, quantize="int8")
    jeng.install_model(MODEL, jcfg, jax.tree.map(jnp.asarray, np_params))
    teng = TorchEngine(registry={MODEL: pcfg}, dtype=torch.float32, device="cpu", quantize="int8")
    teng.install_model(MODEL, pcfg, params_from_numpy(np_params, "cpu", torch.float32))

    jax_rows, jax_texts = _run(jax_study.LlmEnergyConfig, JaxController, jeng, tmp_path / "jax")
    rows, texts = _run(study.LlmEnergyConfig, ExperimentController, teng, tmp_path / "port")
    assert len(rows) == 4 and all(r["__done"] == "DONE" for r in rows)
    same = ("__run_id", "model", "location", "length", "topic", "prompt_tokens",
            "generated_tokens", "chips", "quantize")
    assert [{k: r[k] for k in same} for r in rows] == [{k: r[k] for k in same} for r in jax_rows]
    assert texts == jax_texts
    assert all(1 <= int(r["generated_tokens"]) <= 14 for r in rows)
    for r, jr in zip(rows, jax_rows):
        assert r["backend"] == jr["backend"].replace("JaxEngine", "TorchEngine")
        remote = r["location"] == "remote"
        assert r["backend"].endswith("[aliased-on_device]") == remote
        assert (r["remote_modeled_decode_s"] != "") == remote
        assert float(r["energy_model_J"]) > 0 and float(r["joules_per_token"]) > 0
        assert r["quantize"] == "int8" and r["chips"] == ("8" if remote else "1")
    # the modelled columns of the port's own table come back unchanged
    exp = tmp_path / "port" / study.LlmEnergyConfig.name
    assert (exp / "analysis_report.md").exists()
    modelled = ("energy_model_J", "joules_per_token", "gpu_util_est", "gpu_power_model_W",
                "remote_modeled_decode_s")
    assert study.recompute_energy(exp, registry={MODEL: pcfg}) == 4
    with (exp / "run_table.csv").open() as f:
        again = list(csv.DictReader(f))
    assert [{k: r[k] for k in modelled} for r in again] == [{k: r[k] for k in modelled} for r in rows]


def test_study_without_a_card_raises_and_writes_no_row(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = study.LlmEnergyConfig(results_output_path=tmp_path, **SHARED)
    ctl = ExperimentController(cfg, echo=False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ctl.do_experiment()
    with (tmp_path / cfg.name / "run_table.csv").open() as f:
        assert all(r["__done"] != "DONE" for r in csv.DictReader(f))


# -- the JAX study config's cases on the port ----------------------------------

# The framework-free cases of tests/test_experiment_config.py, loaded with
# the package name swapped to the port's, the experiment's name to
# ``llm_energy_cuda`` and the modelled utilisation column to the port's.
# The fake backend and the HTTP server stay the JAX package's: they are
# fixtures the port has no module for, and the port's ``serve/client.py``
# talks to the server over HTTP. ``profilers.tpu`` stays the JAX
# package's: the aliased-rows case bounds its rows with the v5e watts, so
# it runs with the port billing on the JAX package's TPU constants, as
# does the legacy-table recompute case (it expects the v5e memory duty).
# Left out: both TPU energy-model cases (the GPU model equals the TPU
# model at equal constants, tests/test_torch_profilers.py) and the
# measured-counter case (it patches the TPU counter; its port form, over
# a fake NVML device, is below).
CONFIG_CASES = (
    "test_topics_pool_and_seeded_pick",
    "test_default_sweep_shape",
    "test_energy_window_excludes_transport_time",
    "test_study_resume_reuses_topic",
    "test_remote_runs_do_not_poison_on_device_chip_count",
    "test_backend_column_recorded_per_run",
    "test_describe_backend_for_http_and_engine",
    "test_energy_channels_report_written",
    "test_on_device_url_builds_http_backend_and_checks_health",
    "test_on_device_url_unreachable_fails_fast",
    "test_generation_stats_bill_replicated_kv_per_chip",
    "test_generation_stats_unknown_model_warns_on_aliased_mesh",
    "test_aliased_detection_canonicalizes_urls",
    "test_cooldown_policy_follows_channel_type",
    "test_full_study_lifecycle_on_fake_backend",
    "test_aliased_remote_rows_get_modeled_mesh_duration",
    "test_recompute_energy_reproduces_modelled_columns",
    "test_recompute_energy_fallback_aliasing_for_legacy_tables",
    "test_recompute_energy_skips_rows_missing_raw_inputs",
    "test_recompute_energy_warning_names_the_model",
    "test_recompute_cross_row_aliasing_canonicalizes_backend_urls",
    "test_recompute_does_not_bake_default_chips",
)
# The cases whose bounds are the v5e's: the port bills them on the JAX
# package's TPU constants.
TPU_CONSTANT_CASES = {
    "test_aliased_remote_rows_get_modeled_mesh_duration",
    "test_recompute_energy_fallback_aliasing_for_legacy_tables",
}
CONFIG = port_module(
    "test_experiment_config.py", keep=("profilers.tpu",),
    renames=(('"llm_energy_tpu"', '"llm_energy_cuda"'), ('"tpu_util_est"', '"gpu_util_est"')),
)


V5E_MODEL = dict(
    peak_tflops=tpu.V5E_PEAK_BF16_TFLOPS, peak_w=tpu.V5E_PEAK_W, idle_w=tpu.V5E_IDLE_W,
    spec_hbm_gbps=tpu.V5E_SPEC_HBM_GBPS, cuda_core_ops_per_s=tpu.V5E_VPU_OPS_PER_S,
    tensor_active_w=tpu.V5E_MXU_ACTIVE_W, hbm_active_w=tpu.V5E_HBM_ACTIVE_W,
    cuda_core_active_w=tpu.V5E_VPU_ACTIVE_W,
)


class V5eModel(nvml.GpuEnergyModelProfiler):
    """The port's energy model at the JAX package's v5e constants, which
    make it the JAX model (``tests/test_torch_profilers.py`` pins this);
    keyword arguments override them as they do the H100's."""

    def __init__(self, n_chips=1, **kw):
        super().__init__(n_chips=n_chips, **{**V5E_MODEL, **kw})


def tpu_constants(monkeypatch):
    """Bill the port's study on the JAX package's TPU constants: the v5e
    energy model and the TPU roofline (``generation_stats_from`` then
    equals the JAX one, ``test_generation_stats_equal_jax``)."""
    monkeypatch.setattr(study, "GpuEnergyModelProfiler", V5eModel)
    monkeypatch.setattr(roofline, "SUSTAINED_HBM_GBPS", jax_roofline.V5E_SUSTAINED_HBM_GBPS)
    monkeypatch.setattr(roofline, "NVLINK_GBPS", jax_roofline.ICI_LINK_GBPS)
    monkeypatch.setattr(roofline, "NVLINK_HOP_LATENCY_S", jax_roofline.ICI_HOP_LATENCY_S)


@pytest.mark.parametrize("name", CONFIG_CASES)
def test_jax_study_config_case_on_the_port(name, request, monkeypatch):
    assert CONFIG.LlmEnergyConfig is study.LlmEnergyConfig
    if name in TPU_CONSTANT_CASES:
        tpu_constants(monkeypatch)
    run_case(getattr(CONFIG, name), request)


class _FakeNvml:
    """An NVML device whose counter climbs at ``watts`` from its opening."""

    def __init__(self, watts=120.0):
        self.watts, self.t0 = watts, time.monotonic()

    def total_energy_mj(self):
        return int((time.monotonic() - self.t0) * self.watts * 1000)

    def power_w(self):
        return self.watts


def test_cooldown_and_nvml_follow_what_reads(tmp_path, monkeypatch):
    """Explicit cooldown wins. NVML joins the profilers only when its
    counter reads and this process owns the card (no ``on_device_url``),
    and then the reference's 90 s thermal cooldown returns."""
    assert study.LlmEnergyConfig(cooldown_ms=1234).time_between_runs_in_ms == 1234

    def absent():
        raise nvml.NvmlError("cannot load libnvidia-ml.so.1")

    monkeypatch.setattr(nvml, "nvml_device", absent)
    cfg = study.LlmEnergyConfig()
    assert not any(isinstance(p, nvml.NvmlEnergyProfiler) for p in cfg.profilers)
    host_measured = any(getattr(p, "measured_channel", False) for p in cfg.profilers)
    assert cfg.time_between_runs_in_ms == (
        cfg.MEASURED_CHANNEL_COOLDOWN_MS if host_measured else cfg.MODELLED_ONLY_COOLDOWN_MS)

    monkeypatch.setattr(nvml, "nvml_device", _FakeNvml)
    cfg = study.LlmEnergyConfig()
    assert isinstance(cfg.profilers[0], nvml.NvmlEnergyProfiler)
    assert cfg.time_between_runs_in_ms == cfg.MEASURED_CHANNEL_COOLDOWN_MS
    served = study.LlmEnergyConfig(on_device_url="http://127.0.0.1:9")
    assert not any(isinstance(p, nvml.NvmlEnergyProfiler) for p in served.profilers)
    assert study.LlmEnergyConfig(cooldown_ms=0).time_between_runs_in_ms == 0


def test_study_on_a_reading_nvml_records_measured_joules(tmp_path, monkeypatch):
    """With NVML reading (a fake device at the module's seam), every row
    carries the counter's Joules and the sampled watts beside the
    modelled Joules; the aliased remote rows are billed as an 8-GPU node
    on the roofline's window, between 8 × idle and 8 × the limit."""
    monkeypatch.setattr(nvml, "nvml_device", _FakeNvml)
    slow_fake = FakeBackend(tokens_per_s=400.0, simulate_delay=True)
    cfg = study.LlmEnergyConfig(
        models=[MODEL], locations=["on_device", "remote"], lengths=[100], repetitions=2,
        results_output_path=tmp_path, cooldown_ms=0,
        backends={"on_device": slow_fake, "remote": slow_fake},
    )
    ExperimentController(cfg, echo=False).do_experiment()
    with (tmp_path / cfg.name / "run_table.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4 and all(r["__done"] == "DONE" for r in rows)
    for r in rows:
        window = float(r["execution_time_s"])
        assert float(r["gpu_avg_power_W"]) == 120.0
        assert 0.9 * 120.0 * window <= float(r["gpu_energy_J"]) <= 1.5 * 120.0 * window + 0.1, r
        assert float(r["energy_model_J"]) > 0
        if r["location"] == "remote":
            assert r["backend"].endswith("[aliased-on_device]") and r["chips"] == "8"
            modelled_s = float(r["remote_modeled_decode_s"])
            assert modelled_s != float(r["decode_s"])
            lo, hi = 8 * nvml.H100_IDLE_W * modelled_s, 8 * nvml.H100_PEAK_W * modelled_s
            assert lo * 0.99 <= float(r["energy_model_J"]) <= hi * 1.01, r
        else:
            assert r["remote_modeled_decode_s"] == "" and r["chips"] == "1"


def test_full_study_on_a_reading_nvml_analyses_the_measured_joules(tmp_path, monkeypatch):
    """The port form of the JAX measured-counter case: with NVML reading
    (a fake device at the module's seam), the study's own post-hoc
    analysis takes ``gpu_energy_J`` as THE energy metric, and H2 runs
    unrestricted."""
    import json

    monkeypatch.setattr(nvml, "nvml_device", _FakeNvml)
    slow_fake = FakeBackend(tokens_per_s=400.0, simulate_delay=True)
    cfg = study.LlmEnergyConfig(
        models=["qwen2:1.5b", "gemma:2b"], locations=["on_device", "remote"], lengths=[100],
        repetitions=2, results_output_path=tmp_path, cooldown_ms=0,
        backends={"on_device": slow_fake, "remote": slow_fake}, shuffle=True,
    )
    assert any(isinstance(p, nvml.NvmlEnergyProfiler) for p in cfg.profilers)
    ExperimentController(cfg, echo=False).do_experiment()
    exp = tmp_path / cfg.name
    with (exp / "run_table.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 8 and all(r["__done"] == "DONE" for r in rows)
    assert all(float(r["gpu_energy_J"]) > 0 for r in rows)
    report = json.loads((exp / "analysis_report.json").read_text())
    assert "gpu_energy_J" in report["metrics"]
    assert report["variance_check"]["metric"] == "gpu_energy_J"
    assert report.get("h2_energy_is_modelled") is False
    for per_metric in report["h2_spearman"].values():
        assert not any(h.get("definitional") for h in per_metric.values())


def test_host_sampler_is_built_before_the_first_window(tmp_path, monkeypatch):
    """The native host sampler builds its library (g++, seconds) before
    the study's first measurement window opens: NVML's counter starts
    first, so a build inside the window would be billed to the first
    row's measured Joules."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.native import build
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import native_host

    events = []
    load = native_host.load_sampler_library
    monkeypatch.setattr(native_host, "load_sampler_library",
                        lambda *a, **k: events.append("build") or load(*a, **k))
    nvml_start = nvml.NvmlEnergyProfiler.on_start
    monkeypatch.setattr(nvml.NvmlEnergyProfiler, "on_start",
                        lambda self, ctx: events.append("window") or nvml_start(self, ctx))
    monkeypatch.setattr(nvml, "nvml_device", _FakeNvml)
    fake = FakeBackend(tokens_per_s=5000.0, simulate_delay=True)
    cfg = study.LlmEnergyConfig(
        models=[MODEL], locations=["on_device"], lengths=[100], repetitions=2,
        results_output_path=tmp_path, cooldown_ms=0, backends={"on_device": fake},
    )
    ExperimentController(cfg, echo=False).do_experiment()
    assert events == ["build", "window", "window"], events
    if build.load_sampler_library() is not None:
        host = next(p for p in cfg.profilers if isinstance(p, native_host.NativeHostProfiler))
        assert host._handle is not None


class _TimedBackend:
    """Returns one result with timings finer than the run table keeps."""

    registry = None

    def __init__(self, result):
        self.result = result

    def generate(self, request):
        return self.result


@pytest.mark.parametrize("location", ["on_device", "remote"])
def test_the_port_bills_the_timings_the_table_keeps(location, tmp_path, monkeypatch):
    # The port's study bills its modelled columns on decode_s and total_s
    # rounded to the table's 4 decimals, so recompute_energy gives them
    # back exactly; the JAX study bills the unrounded timings. On the
    # rounded timings the two formulas agree (TPU roofline constants make
    # the port's roofline the JAX one, as above).
    monkeypatch.setattr(roofline, "SUSTAINED_HBM_GBPS", jax_roofline.V5E_SUSTAINED_HBM_GBPS)
    monkeypatch.setattr(roofline, "NVLINK_GBPS", jax_roofline.ICI_LINK_GBPS)
    monkeypatch.setattr(roofline, "NVLINK_HOP_LATENCY_S", jax_roofline.ICI_HOP_LATENCY_S)
    model = "llama3.1:8b"
    port_res, jax_res = _results(model, 57, 134, 2.12345678)
    backend = _TimedBackend(port_res)  # remote aliased to the card
    cfg = study.LlmEnergyConfig(results_output_path=tmp_path, models=[model],
                                backends={"on_device": backend, "remote": backend})
    ctx = RunContext(run_id="run_0_repetition_0", run_nr=1, total_runs=1,
                     variation={"model": model, "location": location, "length": 100},
                     run_dir=tmp_path, experiment_dir=tmp_path,
                     scratch={"request": port_res.request})
    cfg.interact(ctx)
    got = ctx.scratch["generation_stats"]
    remote = location == "remote"
    kw = dict(quantize="int8", n_chips=8 if remote else 1, aliased=remote)
    rounded = dataclasses.replace(jax_res, decode_s=round(jax_res.decode_s, 4),
                                  total_s=round(jax_res.total_s, 4))
    assert got == jax_study.generation_stats_from(jax_config(model), rounded, **kw)
    assert got != jax_study.generation_stats_from(jax_config(model), jax_res, **kw)
