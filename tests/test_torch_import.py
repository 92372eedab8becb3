"""The PyTorch port stands alone: it imports with ``jax`` blocked, and no
module of it imports jax or the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

import cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch as port

PORT_DIR = pathlib.Path(port.__file__).resolve().parent
MODULES = sorted(
    ".".join(("cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch",) + p.relative_to(PORT_DIR).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT_DIR.rglob("*.py")
)
FORBIDDEN = ("jax", "jaxlib", "cain_2025_device_remote_llm_energy_rep_pkg_tpu")
REPO = PORT_DIR.parent
# The port's sources, and the scripts that drive it on the card.
SCRIPTS = [
    REPO / "scripts" / "torch_decode_profile.py",
    REPO / "scripts" / "torch_w4a8_probe.py",
    REPO / "scripts" / "torch_int4_split_sweep.py",
    REPO / "scripts" / "torch_sass_compare.py",
    REPO / "scripts" / "torch_profiler_loss.py",
    REPO / "scripts" / "torch_kernel_trees.py",
    REPO / "scripts" / "torch_parts_grid_sweep.py",
    REPO / "scripts" / "torch_load_headroom.py",
    REPO / "scripts" / "torch_poisson_load.py",
    REPO / "scripts" / "torch_serve_metrics_smoke.py",
    REPO / "examples" / "torch_llm_energy_study.py",
    REPO / "examples" / "torch_llm_energy_sweep.py",
    REPO / "examples" / "torch_llm_energy_capstone.py",
    REPO / "examples" / "torch_llm_energy_real_weights.py",
    REPO / "examples" / "torch_llm_energy_smoke.py",
    REPO / "examples" / "torch_custom_experiment.py",
]
SCANNED = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"] + SCRIPTS


@pytest.mark.parametrize("name", ["engine.speculative", "engine.stepped", "engine.torch_engine"])
def test_the_speculation_modules_are_imported_with_jax_blocked(name):
    assert f"cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize(
    "name", ["engine.paged_kv", "models.transformer", "ops.cuda_paged_attention", "ops.cuda_quant", "ops.quant"]
)
def test_the_write_through_and_w4a8_modules_are_imported_with_jax_blocked(name):
    assert f"cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize(
    "name",
    ["experiments.llm_energy", "obs.tenants", "parallel.roofline", "profilers.energy_probe",
     "profilers.nvml", "runner.controller", "serve.client", "utils.memory"],
)
def test_the_study_modules_are_imported_with_jax_blocked(name):
    assert f"cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize(
    "name",
    ["engine.fake", "engine.stepped", "obs.slo", "obs.timeseries", "serve.scheduler",
     "serve.server", "serve.stream"],
)
def test_the_serving_modules_are_imported_with_jax_blocked(name):
    assert f"cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_the_port_scripts_import_with_jax_blocked(path):
    """Each script imports (its ``main`` does not run) with jax blocked."""
    code = (
        "import sys, importlib.util\n"
        "for name in ('jax', 'jaxlib', 'cain_2025_device_remote_llm_energy_rep_pkg_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"spec = importlib.util.spec_from_file_location('probe', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=str(REPO)
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'cain_2025_device_remote_llm_energy_rep_pkg_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(" + repr(MODULES) + "))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120,
        cwd=str(PORT_DIR.parent),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path}: imports {name}"
