"""The port's two examples against the JAX package's: each runs through
its package's ``runner/cli.py`` on the CPU, the port's with its device
set to the CPU in a copy of its source (the example itself names only the
card), and both ``run_table.csv`` files have the same rows, run ids,
factor values and columns (the device columns swapped: ``tpu_*`` →
``gpu_*``), every row done. Unchanged, each port example refuses to run
where no CUDA device is present."""

import csv
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = "cain_2025_device_remote_llm_energy_rep_pkg_tpu"
PORT_PKG = "cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch"
# name: (JAX example, port example, the port's device put on the CPU,
# output folder of the JAX run, of the port's, factor columns)
EXAMPLES = {
    "smoke": ("llm_energy_smoke.py", "torch_llm_energy_smoke.py",
              ("dtype=torch.float32)", 'dtype=torch.float32, device="cpu")'),
              "llm_energy_tpu", "llm_energy_cuda", ("model", "location", "length", "topic")),
    "custom": ("custom_experiment.py", "torch_custom_experiment.py",
               ('DEVICE = torch.device("cuda")', 'DEVICE = torch.device("cpu")'),
               "matmul_throughput", "matmul_throughput", ("size", "dtype")),
}
DEVICE_COLUMNS = {"tpu_util_est": "gpu_util_est", "tpu_power_model_W": "gpu_power_model_W"}
TIMEOUT_S = 300


def _env():
    """Each run on one CPU thread: the four run at once beside other test
    workers."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _read(path: pathlib.Path):
    with path.open() as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both examples through both packages, the four runs at once."""
    procs = {}
    for name, (jax_file, port_file, (old, new), _, _, _) in EXAMPLES.items():
        src = (REPO / "examples" / port_file).read_text()
        assert src.count(old) == 1, old
        cwd = tmp_path_factory.mktemp(f"port_{name}")
        (cwd / port_file).write_text(src.replace(old, new))
        procs["port", name] = (cwd, subprocess.Popen(
            [sys.executable, "-m", PORT_PKG, port_file], cwd=cwd, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        cwd = tmp_path_factory.mktemp(f"jax_{name}")
        procs["jax", name] = (cwd, subprocess.Popen(
            [sys.executable, "-m", JAX_PKG, str(REPO / "examples" / jax_file)], cwd=cwd, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    try:
        for key, (cwd, proc) in procs.items():
            log, _ = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, (key, log[-3000:])
            folder = EXAMPLES[key[1]][3 if key[0] == "jax" else 4]
            out[key] = _read(cwd / "experiments_output" / folder / "run_table.csv")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_tables_match_the_jax_examples(tables, name):
    factors = EXAMPLES[name][5]
    jax_cols, jax_rows = tables["jax", name]
    port_cols, port_rows = tables["port", name]
    assert port_cols == [DEVICE_COLUMNS.get(c, c) for c in jax_cols]
    assert len(port_rows) == len(jax_rows) == (8 if name == "smoke" else 18)
    assert all(r["__done"] == "DONE" for r in jax_rows + port_rows)

    def factor_rows(rows):
        return [(r["__run_id"], *(r[f] for f in factors)) for r in rows]

    assert factor_rows(port_rows) == factor_rows(jax_rows)
    if name == "smoke":
        assert all(int(r["generated_tokens"]) > 0 for r in port_rows)
        assert {r["model"] for r in port_rows} == {"qwen2:1.5b", "gemma:2b"}
    else:
        assert all(float(r["tflops"]) > 0 and float(r["wall_s"]) > 0 for r in port_rows)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_refuse_to_run_without_a_cuda_device(tmp_path, name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run on it")
    port_file = EXAMPLES[name][1]
    proc = subprocess.run([sys.executable, "-m", PORT_PKG, str(REPO / "examples" / port_file)], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert "CUDA device" in proc.stderr and "none is available" in proc.stderr, proc.stderr[-2000:]
    for table in tmp_path.glob("experiments_output/*/run_table.csv"):
        assert not any(r["__done"] == "DONE" for r in _read(table)[1])
