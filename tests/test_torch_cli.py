"""The port's command line against the JAX package's CLI tests.

The six cases of ``tests/test_cli.py`` that do not serve run on the
port's ``runner/cli.py`` (the file's source with the package name
swapped): the scaffold, the two config-class lookups, a config file run
end to end, help and an unknown command, and ``prepare``'s cooldown
promise, whose device channel is the port's NVML one; and its four
replica-router and multi-model cases (``--replicas`` / ``--route-policy``
/ ``--probe-interval-ms``, ``--model-policy`` / ``--escalate-max-tokens``,
both together, ``serve-fleet --targets``), whose stand-in servers gain
the ``stop()`` that the port's serve loop calls after ``serve_forever``;
and its ten cases of ``serve``'s knobs (speculation on the engine and on
the fake backend, per-model ``--quantize``, the scheduler, slice, chunk,
TTFT-SLO, preemption and prefix-store options, each reaching the engine
or the server), where ``--backend jax`` reads ``--backend torch`` and the
engine is built on the CPU (``engines_built_on_the_cpu``).
Then the port's own cases: ``serve --backend jax`` and ``serve-fleet``
without ``--targets`` exit 2, ``--roles`` assigns the replicas' roles,
``serve
--backend torch-tp --tp N [--dp M]`` lays its mesh over the visible GPUs
(exit 2 without one, or with fewer than the mesh needs), ``analyze`` and
``recompute-energy`` run over a study table the port wrote, and ``python
-m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch help`` runs in a
fresh interpreter with jax blocked.
"""

import subprocess
import sys
import textwrap

import pytest

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner import cli
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner.persistence import RunTableStore
from test_torch_runner import PORT, TESTS, engines_built_on_the_cpu, port_module, run_case
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

CLI_CASES = (
    "test_config_create_scaffold_is_loadable",
    "test_load_rejects_configless_module",
    "test_load_prefers_runnerconfig_name_on_ambiguity",
    "test_run_config_file_end_to_end",
    "test_main_help_and_unknown_command",
    "test_prepare_cooldown_promise_matches_consumed_channels",
    "test_serve_replica_fleet_knobs",
    "test_serve_model_policy_knobs",
    "test_serve_replicas_with_model_policy_builds_fleet_lanes",
    "test_serve_fleet_command_knobs",
    "test_speculative_flag_parsing_handles_colon_names",
    "test_serve_speculative_knobs_reach_engine_and_server",
    "test_serve_fake_backend_speculative_knobs",
    "test_serve_quantize_per_model_spec_parses",
    "test_serve_scheduler_and_window_flags",
    "test_serve_slice_and_chunk_knobs",
    "test_serve_ttft_slo_knob",
    "test_serve_preemption_knobs",
    "test_serve_prefix_share_knobs",
    "test_serve_prefix_store_budget_knobs",
)
CLI = port_module(
    "test_cli.py",
    renames=(
        ('"libtpu_monitoring"', '"nvml"'),
        (
            "        def serve_forever(self):\n            return None\n",
            "        def serve_forever(self):\n            return None\n\n"
            "        def stop(self):\n            return None\n",
        ),
        ('"--backend", "jax"', '"--backend", "torch"'),
    ),
)


@pytest.mark.parametrize("name", CLI_CASES)
def test_jax_cli_case_on_the_port(name, request):
    assert CLI.main is cli.main
    with engines_built_on_the_cpu():
        run_case(getattr(CLI, name), request)


@pytest.mark.parametrize("command", ["serve", "serve-fleet"])
def test_serve_commands_exit_2_until_serving_is_ported(command, capsys):
    """``serve`` does not run over the JAX package's engines: it names the
    port's own; ``serve-fleet`` needs the servers it routes to."""
    extra = ["--backend", "jax"] if command == "serve" else []
    assert cli.main([command, "--port", "0", *extra]) == 2
    out = capsys.readouterr().out
    assert ("--backend torch-tp" if command == "serve" else "--targets host:port") in out


def test_serve_roles_assign_each_replica_its_role(monkeypatch):
    """``--replicas N --roles prefill,decode`` gives replica i the role
    ``roles[i % len(roles)]`` (the JAX package's cycling rule); without
    ``--roles`` every replica takes ``--role`` (default mixed); a role
    outside ``SERVER_ROLES`` fails fast."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve import router as rt

    captured = {}

    class StandIn:
        def __init__(self, router, **kw):
            captured["router"] = router

        def serve_forever(self):
            return None

        def stop(self):
            captured["router"].stop()

    monkeypatch.setattr(rt, "RouterServer", StandIn)
    for extra, roles in (
        (["--roles", "prefill,decode"], ["prefill", "decode", "prefill"]),
        (["--role", "decode"], ["decode"] * 3),
        ([], ["mixed"] * 3),
    ):
        cli.serve_command(["--backend", "fake", "--port", "0", "--replicas", "3", *extra])
        assert [r.role for r in captured["router"].replicas()] == roles
    with pytest.raises(cli.CommandError, match="--roles"):
        cli.serve_command(["--replicas", "2", "--roles", "prefill,bogus"])


def test_serve_torch_tp_without_a_gpu_exits_2_and_builds_nothing(monkeypatch, capsys):
    """On a host without a GPU ``--backend torch-tp`` has no devices to
    lay its mesh over: exit 2, and no engine on the CPU."""
    import torch

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel import tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tp, "TensorParallelEngine", lambda **kw: pytest.fail("built an engine"))
    assert cli.main(["serve", "--port", "0", "--backend", "torch-tp", "--tp", "2"]) == 2
    assert "has none" in capsys.readouterr().out


@pytest.mark.parametrize(
    "args,gpus,axes",
    [
        (["--tp", "2"], 2, {"tp": 2}),
        (["--tp", "2", "--dp", "2"], 4, {"dp": 2, "tp": 2}),
        ([], 4, {"tp": 4}),
        (["--tp", "4"], 2, None),
    ],
)
def test_serve_torch_tp_builds_the_mesh_over_the_visible_gpus(args, gpus, axes, monkeypatch, capsys):
    """``--tp N [--dp M]`` lays MeshSpec.dp_tp(M, N) (tp_only(N) without
    --dp; every GPU on tp without --tp) over the visible GPUs; a mesh
    larger than the GPU count exits 2 with resolve's message."""
    import torch

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel import mesh, tp

    built, served = [], []
    monkeypatch.setattr(mesh, "visible_devices", lambda: [torch.device("cuda", i) for i in range(gpus)])
    monkeypatch.setattr(tp, "TensorParallelEngine", lambda **kw: built.append(kw) or FakeBackend())
    monkeypatch.setattr(cli, "_serve_until_signalled", served.append)
    argv = ["serve", "--port", "0", "--backend", "torch-tp", "--paged-kv", "--scheduler", "continuous", *args]
    if axes is None:
        assert cli.main(argv) == 2
        assert f"needs 4 devices, have {gpus}" in capsys.readouterr().out
        assert not built
        return
    assert cli.main(argv) == 0
    (kw,) = built
    assert kw["mesh"].shape == axes
    assert list(kw["mesh"].devices) == [torch.device("cuda", i) for i in range(gpus)]
    assert kw["paged_kv"] is True and len(served) == 1


def test_prepare_without_a_card_says_so_and_runs_nothing(monkeypatch, capsys):
    import torch

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import _kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_kernels, "build", lambda *a, **k: pytest.fail("built without a card"))
    assert cli.main(["prepare"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "no CUDA device" in out


def _study_config(tmp_path):
    path = tmp_path / "study.py"
    path.write_text(textwrap.dedent(f"""
        from {PORT}.experiments.llm_energy import LlmEnergyConfig
        from {PORT}.engine.fake import FakeBackend

        _FAKE = FakeBackend(tokens_per_s=5000.0, simulate_delay=True)


        class RunnerConfig(LlmEnergyConfig):
            def __init__(self):
                super().__init__(
                    models=["qwen2:1.5b", "gemma:2b"], lengths=[100], repetitions=2,
                    cooldown_ms=0, results_output_path={str(tmp_path)!r},
                    backends={{"on_device": _FAKE, "remote": _FAKE}}, shuffle=False,
                )
    """))
    return path


def test_study_config_file_then_analyze_and_recompute(tmp_path):
    """The study through the command line (a fake backend stands in for
    the card): the run writes its table and analysis; ``analyze`` writes
    the report again; ``recompute-energy`` leaves the modelled columns
    as they were; bad flags exit 2."""
    assert cli.main([str(_study_config(tmp_path))]) == 0
    exp = tmp_path / "llm_energy_cuda"
    rows = RunTableStore(exp).read()
    assert len(rows) == 8 and all(r["__done"] == "DONE" for r in rows)
    report = exp / "analysis_report.md"
    assert report.exists()
    report.unlink()
    assert cli.main(["analyze", str(exp), "--filter-scope", "subset"]) == 0
    assert "subset" in report.read_text()
    modelled = ("energy_model_J", "joules_per_token", "gpu_util_est", "gpu_power_model_W",
                "remote_modeled_decode_s")
    before = [{k: r[k] for k in modelled} for r in rows]
    assert cli.main(["recompute-energy", str(exp)]) == 0
    after = [{k: r[k] for k in modelled} for r in RunTableStore(exp).read()]
    assert after == before
    assert cli.main(["recompute-energy", str(exp), "--quantize", "qwen2:1.5b=int3"]) == 2
    assert cli.main(["recompute-energy", str(exp), "--chips", "remote"]) == 2
    assert cli.main(["recompute-energy"]) == 2
    assert cli.main(["analyze", str(exp), "--filter-scope", "rows"]) == 2
    assert cli.main(["analyze", str(tmp_path / "missing")]) == 2
    # a finished table: the run refuses, exit 1, the table untouched
    assert cli.main([str(_study_config(tmp_path))]) == 1
    assert len(RunTableStore(exp).read()) == 8


def test_module_help_runs_with_jax_blocked():
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'cain_2025_device_remote_llm_energy_rep_pkg_tpu'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['x', 'help']\n"
        f"runpy.run_module({PORT!r}, run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(TESTS.parent),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"usage: python -m {PORT} ")
    assert "recompute-energy" in proc.stdout and "serve [opts]" in proc.stdout
    assert "serve-fleet" in proc.stdout
    assert "--backend\n                       torch|fake" in proc.stdout


def test_module_unknown_command_exits_2():
    proc = subprocess.run(
        [sys.executable, "-m", PORT, "no-such-command"], capture_output=True, text=True,
        timeout=120, cwd=str(TESTS.parent),
    )
    assert proc.returncode == 2, proc.stderr
