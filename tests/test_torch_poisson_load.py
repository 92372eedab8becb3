"""The port's load generator, ``scripts/torch_poisson_load.py``, against the
JAX package's ``scripts/poisson_load.py``: for a seed both draw the same
workload on every stream (arrival offsets, prompts, budgets, tiers,
models, temperatures, tenants, deadlines and cancellations, all exact),
and both ``--fake`` CLIs print the same summary once the timing fields are
left out. Then the port's ``--url`` CLI against a port server on the fake
backend, with the gates ``chip_smoke.py``'s ``poisson_load_cli`` phase
holds it to on the GPU: every request answered and retired once by the
server, as cancelled no more often than its clients hung up."""

import dataclasses
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import pytest

from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "poisson_load.py"
PORT_SCRIPT = REPO / "scripts" / "torch_poisson_load.py"
N = 24


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"_{path.stem}_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_LOAD = _load(JAX_SCRIPT)
PORT_LOAD = _load(PORT_SCRIPT)

# Each stream as build_workload's keyword arguments, built by the module
# under test from its own parser; "cancel" is build_cancellations'.
STREAMS = {
    "fixed": lambda m: {},
    "lognormal": lambda m: {"prompt_len_dist": "lognormal", "prompt_len_median": 48.0, "prompt_len_max": 512,
                            "anchor_longest": True},
    "shared_prefix": lambda m: {"shared_prefix_frac": 0.5, "prefix_pool": 3, "shared_prefix_tokens": 64,
                                "anchor_shared_prefix": True},
    "tier_mix": lambda m: {"tier_mix": m.parse_tier_mix("high=0.2,low=0.5")},
    "model_mix": lambda m: {"model": "auto", "model_mix": m.parse_model_mix("small:1b=0.5,big:7b=0.3")},
    "temperature": lambda m: {"temperature_dist": m.parse_temperature_dist("0.7=0.6,1.0=0.2")},
    "tenant_mix": lambda m: {"tenant_mix": m.parse_tenant_mix("acme=0.6,beta=0.3")},
    "deadline": lambda m: {"deadline_ms": 500.0},
    "cancel": None,
}


def _draws(mod, seed: int, stream: str):
    if STREAMS[stream] is None:
        return mod.build_cancellations(N, 0.25, after_tokens=(4, 32), seed=seed)
    workload = mod.build_workload(N, 0.05, seed=seed, **STREAMS[stream](mod))
    out = []
    for t, req in workload:
        fields = dataclasses.asdict(dataclasses.replace(req, trace=None))
        out.append((t, fields))
    return out


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_workload_draws_match_the_jax_script(seed, stream):
    want = _draws(JAX_LOAD, seed, stream)
    got = _draws(PORT_LOAD, seed, stream)
    assert got == want
    # the stream drew something other than its default
    assert want != _draws(JAX_LOAD, seed + 4, stream)


def test_the_defaults_and_every_flag_are_the_jax_scripts():
    assert PORT_LOAD.DEFAULT_BUDGETS == JAX_LOAD.DEFAULT_BUDGETS == (8, 16, 48)
    assert PORT_LOAD.DEFAULT_PROMPTS == JAX_LOAD.DEFAULT_PROMPTS

    def flags(path):
        return sorted(set(re.findall(r'add_argument\(\s*"(-[-\w]+)"', path.read_text())))

    assert flags(PORT_SCRIPT) == flags(JAX_SCRIPT)


# Summary keys that read the clock: percentiles, rates and seconds.
def _untimed(value):
    if isinstance(value, dict):
        return {k: _untimed(v) for k, v in value.items() if not (k.endswith("_s") or k.endswith("_per_s"))}
    return value


FAKE_RUNS = {
    "model_tenant_joules": ["-n", "12", "--model-mix", "small:1b=0.5,big:7b=0.5", "--tenant-mix", "a=0.6,b=0.4",
                            "--fake-joules-per-token", "0.01"],
    "sessions_prefix_share": ["-n", "12", "--sessions", "2", "--prefix-share", "--shared-prefix-frac", "0.5"],
}


@pytest.mark.parametrize("run", sorted(FAKE_RUNS))
def test_fake_cli_summaries_match_the_jax_script(run):
    argv = ["--fake", "--seed", "1", "--mean-interarrival-ms", "50", *FAKE_RUNS[run]]
    procs = [subprocess.Popen([sys.executable, str(path), *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO) for path in (JAX_SCRIPT, PORT_SCRIPT)]
    summaries = []
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-2000:]
        lines = out.strip().splitlines()
        assert len(lines) == 1, out
        summaries.append(json.loads(lines[0]))
    want, got = summaries
    assert want["errors"] == 0 and want["requests"] == 12
    assert _untimed(got) == _untimed(want)


def test_url_cli_passes_the_chip_phase_gates_against_a_port_server():
    """``chip_smoke.py``'s ``poisson_load_cli`` phase, as it runs on the
    card, against a port server over the fake backend, decoding at 25
    tokens/s (a 16-step slice in 0.64 s)."""
    import chip_smoke
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.server import GenerationServer

    server = GenerationServer(FakeBackend(tokens_per_s=25.0, simulate_delay=True), host="127.0.0.1", port=0,
                              quiet=True, scheduler="continuous")
    server.start()
    try:
        summary = chip_smoke.poisson_load_cli_phase(REPO, f"http://127.0.0.1:{server.port}", "cpu (not measured)")
    finally:
        server.stop()
    assert summary["requests"] == chip_smoke.POISSON_LOAD_REQUESTS and summary["tokens"] > 0
