"""The port's analysis pipeline against the JAX package's.

Every case of ``tests/test_analysis.py`` runs on the port's
``analysis/*`` with the measured and modelled device columns renamed to
the port's (``tpu_energy_J`` → ``gpu_energy_J``, ``tpu_util_est`` →
``gpu_util_est``, ``tpu_power_model_W`` → ``gpu_power_model_W``). The
committed sample run (``docs/sample_run``) carries the JAX package's
column names, so its cases read a copy whose header is renamed the same
way; its recompute case bills on the JAX package's TPU constants, which
make the port's energy model the JAX one. Then one table of study rows
goes through both pipelines, and the two reports must agree to 1e-12.
Last, the pin for the column the port's study must analyse: NVML's
measured ``gpu_energy_J`` outranks the modelled ``energy_model_J``.
"""

import csv
import json
import math
import shutil

import numpy as np
import pytest

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.analysis import pipeline as jax_pipeline
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.analysis import pipeline
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.persistence import RunTableStore
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.progress import RunProgress
from test_torch_runner import TESTS, port_module, run_case
from test_torch_study import tpu_constants
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

COLUMN_RENAMES = (
    ("tpu_energy_J", "gpu_energy_J"),
    ("tpu_util_est", "gpu_util_est"),
    ("tpu_power_model_W", "gpu_power_model_W"),
)
SAMPLE = TESTS.parent / "docs" / "sample_run"
ANALYSIS = port_module(
    "test_analysis.py",
    renames=COLUMN_RENAMES
    + (('Path(__file__).parent.parent / "docs" / "sample_run"', "_port_sample()"),),
)
CASES = sorted(
    name for name in vars(ANALYSIS)
    if name.startswith("test_") and callable(getattr(ANALYSIS, name))
)
# The cases whose run bills the sample's rows again, on the JAX package's
# TPU constants.
TPU_CONSTANT_CASES = {"test_shipped_capstone_recompute_is_deterministic"}


def _translated_sample(out):
    """A copy of the committed sample run with the port's column names."""
    out.mkdir(parents=True, exist_ok=True)
    for path in SAMPLE.iterdir():
        if path.is_file():
            shutil.copy(path, out / path.name)
    table = out / "run_table.csv"
    if table.exists():
        header, rest = table.read_text().split("\n", 1)
        for old, new in COLUMN_RENAMES:
            header = ",".join(new if c == old else c for c in header.split(","))
        table.write_text(header + "\n" + rest)
    return out


@pytest.fixture
def port_sample(tmp_path, monkeypatch):
    out = tmp_path / "sample_run"
    monkeypatch.setattr(ANALYSIS, "_port_sample", lambda: out, raising=False)
    if SAMPLE.is_dir():
        _translated_sample(out)
    return out


def test_every_jax_analysis_case_is_loaded():
    assert len(CASES) == 34


@pytest.mark.parametrize("name", CASES)
def test_jax_analysis_case_on_the_port(name, request, port_sample, monkeypatch):
    if name in TPU_CONSTANT_CASES:
        tpu_constants(monkeypatch)
    run_case(getattr(ANALYSIS, name), request)


# -- one table through both pipelines -----------------------------------------

def _study_rows(measured: str):
    """2 models × 2 locations × 3 lengths × 6 repetitions of study-shaped
    rows from a seeded generator; ``measured`` names the device counter's
    column."""
    rng = np.random.default_rng(11)
    rows = []
    i = 0
    for model, scale in (("qwen2:1.5b", 1.0), ("llama3.1:8b", 4.5)):
        for location, factor in (("on_device", 1.0), ("remote", 1.7)):
            for length in (100, 500, 1000):
                for rep in range(6):
                    tokens = int(math.ceil(length * 4 / 3) - rng.integers(0, 3))
                    decode = scale * tokens * 0.035 * rng.uniform(0.93, 1.07)
                    total = decode + rng.uniform(0.02, 0.06)
                    rows.append({
                        "__run_id": f"run_{i}_repetition_{rep}",
                        "__done": RunProgress.DONE,
                        "model": model,
                        "location": location,
                        "length": length,
                        "generated_tokens": tokens,
                        "execution_time_s": round(total, 4),
                        "decode_s": round(decode, 4),
                        "tokens_per_s": round(tokens / decode, 2),
                        measured: round(total * 270.0 * factor * rng.uniform(0.95, 1.05), 4),
                        "energy_model_J": round(decode * 73.0 * factor, 4),
                        "joules_per_token": round(decode * 73.0 * factor / tokens, 4),
                        "remote_modeled_decode_s": round(decode / 3.5, 4) if location == "remote" else None,
                        "cpu_usage": round(rng.uniform(5, 15), 2),
                        "memory_usage": round(rng.uniform(20, 22), 3),
                    })
                i += 1
    return rows


def _same(a, b, path="report"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for key in a:
            _same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b, rel=1e-12, abs=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _renamed(obj):
    """The JAX report with its device column names as the port's."""
    text = json.dumps(obj)
    for old, new in COLUMN_RENAMES:
        text = text.replace(old, new)
    return json.loads(text)


@pytest.mark.parametrize("filter_scope", ["cell", "subset", "pooled"])
def test_one_study_table_gives_the_same_report_through_both_pipelines(tmp_path, filter_scope):
    reports = {}
    for key, mod, measured in (("jax", jax_pipeline, "tpu_energy_J"), ("port", pipeline, "gpu_energy_J")):
        exp = tmp_path / key
        RunTableStore(exp).write(_study_rows(measured))
        reports[key] = mod.analyze_experiment(exp, filter_scope=filter_scope)
    jax_report, report = _renamed(reports["jax"]), reports["port"]
    assert report["variance_check"]["metric"] == "gpu_energy_J"
    for h in report["h1_energy_by_length"].values():  # Wilcoxon p, Cliff's δ
        assert 0 <= h["p"] <= 1 and -1 <= h["cliffs_delta"] <= 1
    assert report["h2_spearman"]["on_device"]["execution_time_s"]["rho"] > 0.9
    _same(jax_report, report)
    assert (tmp_path / "port" / "analysis_report.md").read_text() == _renamed(
        (tmp_path / "jax" / "analysis_report.md").read_text())


# -- the column the port's study analyses ---------------------------------------

def test_nvml_joules_outrank_the_modelled_joules(tmp_path):
    cols = pipeline.KNOWN_METRIC_COLUMNS
    assert cols.index("gpu_energy_J") < cols.index("energy_model_J") < cols.index("host_energy_J")
    assert "tpu_energy_J" not in cols and "tpu_util_est" not in cols
    for name in ("gpu_util_est", "gpu_power_model_W"):
        assert name in pipeline.MODELLED_ENERGY_DERIVED
    # the port's study table: both energies, the modelled companions and
    # the sampled watts, as NvmlEnergyProfiler and GpuEnergyModelProfiler
    # write them
    rows = _study_rows("gpu_energy_J")
    for r in rows:
        r["gpu_avg_power_W"] = round(r["gpu_energy_J"] / r["execution_time_s"], 3)
        r["gpu_util_est"], r["gpu_power_model_W"] = 0.013, 73.0
    RunTableStore(tmp_path).write(rows)
    report = pipeline.analyze_experiment(tmp_path)
    assert report["variance_check"]["metric"] == "gpu_energy_J"
    assert report["h2_energy_is_modelled"] is False
    md = (tmp_path / "analysis_report.md").read_text()
    assert "gpu_energy_J" in md
    with (tmp_path / "descriptives.tex").open() as f:
        assert f.read() == pipeline.render_latex_descriptives(report, "gpu_energy_J")


def test_the_port_table_without_a_counter_analyses_the_model(tmp_path):
    rows = _study_rows("gpu_energy_J")
    for r in rows:
        r["gpu_energy_J"] = None
    RunTableStore(tmp_path).write(rows)
    report = pipeline.analyze_experiment(tmp_path)
    assert report["variance_check"]["metric"] == "energy_model_J"
    assert report["h2_energy_is_modelled"] is True


def test_translated_sample_keeps_every_row(tmp_path):
    if not (SAMPLE / "run_table.csv").exists():
        pytest.skip("sample run not present")
    out = _translated_sample(tmp_path / "s")
    with (SAMPLE / "run_table.csv").open() as f:
        jax_rows = list(csv.DictReader(f))
    with (out / "run_table.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(jax_rows) == 1260
    for old, new in COLUMN_RENAMES[1:]:
        assert [r[new] for r in rows] == [r[old] for r in jax_rows]
