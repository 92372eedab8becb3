"""The port's runner against the JAX package's runner tests.

Every case of ``tests/test_{controller,events,factors,persistence,resume}.py``
runs here a second time, on the port: each file's source is loaded with
the JAX package's name replaced by the port's, so the same test bodies
drive the port's ``runner`` modules. Then one small config runs through
both packages' controllers and their run tables must agree.
"""

import contextlib
import csv
import inspect
import json
import re
import time
import types
from pathlib import Path

import pytest

import cain_2025_device_remote_llm_energy_rep_pkg_tpu as jax_pkg
import cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch as port_pkg
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.profilers.synthetic import (
    SyntheticPowerProfiler as JaxSynthetic,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.runner.controller import (
    ExperimentController as JaxController,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers.synthetic import (
    SyntheticPowerProfiler as PortSynthetic,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.controller import (
    ExperimentController as PortController,
)

JAX = jax_pkg.__name__
PORT = port_pkg.__name__
TESTS = Path(__file__).resolve().parent
FILES = ("test_controller.py", "test_events.py", "test_factors.py",
         "test_persistence.py", "test_resume.py")


def port_module(file_name: str, keep=(), renames=()) -> types.ModuleType:
    """The JAX package's test file ``file_name``, its imports pointed at
    the port. The modules in ``keep`` (dotted paths inside the package)
    stay the JAX package's: fixtures the port has no module for, such as
    a fake backend or a server that the port's client talks to. Each
    ``(old, new)`` of ``renames`` is then replaced in the source."""
    path = TESTS / file_name
    src = re.sub(rf"\b{JAX}\b", PORT, path.read_text())
    for name in keep:
        src = src.replace(f"{PORT}.{name}", f"{JAX}.{name}")
    for old, new in renames:
        assert old in src, old
        src = src.replace(old, new)
    kept = re.findall(rf"\b{JAX}\.([\w.]+)", src)
    assert set(kept) <= set(keep) and f"import {JAX}\n" not in src, kept
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def load_cases(namespace: dict, file_name: str, renames=(), leave_out=(), only=None, keep=()) -> list:
    """Load the JAX package's test file ``file_name`` onto the port (see
    :func:`port_module`, which takes ``keep`` and ``renames``) into
    ``namespace``, a test module's globals, so that pytest collects its
    cases, fixtures and parametrizations there as its own. The cases
    named in ``leave_out`` are not loaded, nor, when ``only`` names some,
    any other. Returns the names of the loaded cases."""
    mod = port_module(file_name, keep=keep, renames=renames)
    cases = [n for n in vars(mod) if n.startswith("test_") and callable(getattr(mod, n))]
    if only is not None:
        assert set(only) <= set(cases), set(only) - set(cases)
        leave_out = tuple(leave_out) + tuple(n for n in cases if n not in only)
    assert set(leave_out) <= set(cases), set(leave_out) - set(cases)
    for name, value in vars(mod).items():
        if not name.startswith("__") and name not in leave_out:
            namespace[name] = value
    return [n for n in cases if n not in leave_out]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module, restored after it: a tiny
    model's ops are too small to split, and parallel test workers that
    each spin a pool of every core oversubscribe the host (a module of
    speculative sessions ran over 10× slower under six workers). Import it
    into a test module to apply it there."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def engines_built_on_the_cpu():
    """``TorchEngine`` built as the loaded JAX cases build ``JaxEngine``:
    on the CPU unless a case names a device (the port's engine runs on
    the card unless told otherwise), and a JAX dtype such as
    ``jnp.float32`` read as its torch twin. Nothing else of the engine
    changes."""
    import numpy as np
    import torch

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine

    init = torch_engine.TorchEngine.__init__

    def on_the_cpu(self, registry=None, dtype=torch.bfloat16, *args, device="cpu", **kwargs):
        if dtype is not None and not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        init(self, registry, dtype, *args, device=device, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch_engine.TorchEngine, "__init__", on_the_cpu)
        yield


@pytest.fixture(autouse=True, scope="module")
def engines_on_the_cpu():
    """:func:`engines_built_on_the_cpu` for a whole module, its
    module-scoped fixtures included. Import it into a test module to
    apply it there."""
    with engines_built_on_the_cpu():
        yield


MODULES = {f: port_module(f) for f in FILES}
CASES = [
    (f, name) for f, mod in MODULES.items() for name in sorted(vars(mod))
    if name.startswith("test_") and callable(getattr(mod, name))
]


def run_case(fn, request):
    kwargs = {name: request.getfixturevalue(name) for name in inspect.signature(fn).parameters}
    fn(**kwargs)


def test_the_loaded_cases_use_only_the_port():
    assert len(CASES) == 44
    for mod in MODULES.values():
        for value in vars(mod).values():
            owner = getattr(value, "__module__", None) or ""
            assert not owner.startswith(JAX + ".") or owner.startswith(PORT), (mod, value)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][:-3]}::{c[1]}")
def test_jax_runner_case_on_the_port(case, request):
    file_name, name = case
    run_case(getattr(MODULES[file_name], name), request)


SAMPLE_WAIT_S = 5.0


def _config(pkg, synthetic, out: Path):
    """Two factors, two repetitions, shuffled with a seed; one synthetic
    power profiler; a row value from the factors."""
    from importlib import import_module

    base = import_module(f"{pkg}.runner.config").ExperimentConfig
    factors = import_module(f"{pkg}.runner.factors")

    class Small(base):
        name = "small_study"
        results_output_path = out
        isolate_runs = False
        time_between_runs_in_ms = 0

        def __init__(self):
            self.profilers = [synthetic(period_s=0.005, base_w=50.0)]

        def create_run_table_model(self):
            return factors.RunTableModel(
                factors=[factors.Factor("size", [1, 2, 3]), factors.Factor("mode", ["a", "bb"])],
                repetitions=2,
                data_columns=["value"],
                shuffle=True,
                shuffle_seed=7,
            )

        def interact(self, context):
            # until the sampler's thread has taken a reading (bounded): a
            # fixed sleep of two periods can pass unsampled on a loaded
            # host, leaving one reading and 0 J
            deadline = time.monotonic() + SAMPLE_WAIT_S
            time.sleep(0.01)
            while not self.profilers[0]._samples and time.monotonic() < deadline:
                time.sleep(0.005)

        def populate_run_data(self, context):
            return {"value": context.factor("size") * 10 + len(context.factor("mode"))}

    return Small()


def _table(path: Path):
    with (path / "run_table.csv").open() as f:
        return list(csv.DictReader(f))


def test_one_config_gives_the_same_run_table_through_both_controllers(tmp_path):
    tables = {}
    for key, pkg, synthetic, controller in (
        ("jax", JAX, JaxSynthetic, JaxController),
        ("port", PORT, PortSynthetic, PortController),
    ):
        cfg = _config(pkg, synthetic, tmp_path / key)
        ctl = controller(cfg, echo=False)
        ctl.do_experiment()
        exp = tmp_path / key / "small_study"
        events = [json.loads(line)["event"] for line in (exp / "experiment_log.jsonl").open()]
        tables[key] = (_table(exp), sorted(p.name for p in exp.iterdir() if p.is_dir()), events,
                       json.loads((exp / "metadata.json").read_text()))
    (jax_rows, jax_dirs, jax_events, jax_meta), (rows, dirs, events, meta) = tables["jax"], tables["port"]
    assert len(rows) == 12 and all(r["__done"] == "DONE" for r in rows)
    timed = {"energy_J"}  # integrated over each run's own wall time
    assert [{k: v for k, v in r.items() if k not in timed} for r in rows] == [
        {k: v for k, v in r.items() if k not in timed} for r in jax_rows
    ]
    assert [r["avg_power_W"] for r in rows] == ["50.0"] * 12
    assert all(float(r["energy_J"]) > 0 for r in rows)
    assert (dirs, events, meta) == (jax_dirs, jax_events, jax_meta)
