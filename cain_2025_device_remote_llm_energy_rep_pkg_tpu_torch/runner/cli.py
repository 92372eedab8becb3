"""CLI entry point: run a config file, or scaffold/describe/analyse one.

Reference: ``experiment-runner/__main__.py`` (config-file dispatch :52-79,
dynamic import :19-25, AST md5 :27-49) and
``ConfigValidator/CLIRegister/CLIRegister.py`` (command registry: config-create
/ prepare / help, :105-125). Usage::

    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch <config.py>
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch config-create [dir]
    python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch help

The study commands of the JAX package's CLI, on the port. ``prepare``
checks torch, the CUDA card (its name and power limit through NVML) and
the build of the port's kernels. ``serve`` runs the HTTP generation
server over ``TorchEngine`` on the card (``--backend torch``, the
default) or the fake backend; the options of the layers not ported yet
(the JAX engines, tensor parallelism, the replica router and the
multi-model fleet) exit with code 2 naming their ROADMAP item, as
``serve-fleet`` does.
"""

from __future__ import annotations

import importlib.util
import inspect
import multiprocessing
import signal
import sys
import threading
import uuid
from pathlib import Path
from typing import List, Optional, Type

from . import term
from .config import ExperimentConfig
from .controller import ExperimentController
from .errors import CommandError, ConfigLoadError, ExperimentError

_TEMPLATE = '''"""Experiment config scaffold (edit every TODO)."""

from pathlib import Path

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import (
    ExperimentConfig,
    Factor,
    RunTableModel,
)


class MyExperiment(ExperimentConfig):
    name = "new_runner_experiment"
    results_output_path = Path("experiments_output")
    time_between_runs_in_ms = 1000

    def create_run_table_model(self) -> RunTableModel:
        return RunTableModel(
            factors=[
                Factor("example_factor", ["treatment_a", "treatment_b"]),
            ],
            repetitions=1,
            data_columns=["example_metric"],
        )

    def start_run(self, context):
        pass  # TODO: start the measured activity

    def interact(self, context):
        pass  # TODO: wait for the activity to finish

    def populate_run_data(self, context):
        return {"example_metric": 0}  # TODO: report measurements
'''


def load_config_class(path: Path) -> Type[ExperimentConfig]:
    """Import a config module and find its ExperimentConfig subclass.

    The reference requires the class be named exactly ``RunnerConfig``
    (__main__.py:62-71); any single subclass is accepted here, with the name
    ``RunnerConfig`` preferred when several are defined.
    """
    spec = importlib.util.spec_from_file_location(f"_expconfig_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ConfigLoadError(f"cannot import config file: {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    candidates: List[Type[ExperimentConfig]] = [
        obj
        for _, obj in inspect.getmembers(module, inspect.isclass)
        if issubclass(obj, ExperimentConfig)
        and obj is not ExperimentConfig
        and obj.__module__ == module.__name__
    ]
    if not candidates:
        raise ConfigLoadError(f"no ExperimentConfig subclass found in {path}")
    if len(candidates) > 1:
        named = [c for c in candidates if c.__name__ == "RunnerConfig"]
        if len(named) == 1:
            return named[0]
        raise ConfigLoadError(
            f"multiple ExperimentConfig subclasses in {path}: "
            f"{[c.__name__ for c in candidates]}; name one 'RunnerConfig'"
        )
    return candidates[0]


def run_config_file(path: Path) -> None:
    if not path.exists():
        raise CommandError(f"config file does not exist: {path}")
    # Children must inherit the wired event bus and config state.
    if multiprocessing.get_start_method(allow_none=True) != "fork":
        multiprocessing.set_start_method("fork", force=True)
    cls = load_config_class(path)
    config = cls()
    controller = ExperimentController(config, config_source=path.read_text())
    controller.do_experiment()


def config_create(target_dir: Optional[Path]) -> Path:
    """Scaffold a fresh config file (reference CLIRegister.py:14-61)."""
    target = target_dir or Path("examples")
    target.mkdir(parents=True, exist_ok=True)
    out = target / f"RunnerConfig-{uuid.uuid1()}.py"
    out.write_text(_TEMPLATE)
    term.log_ok(f"created config scaffold: {out}")
    return out


HELP = """usage: python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch <command|config.py>

commands:
  <config.py>          run the experiment defined by the config file
  config-create [dir]  scaffold a new config file (default dir: examples/)
  analyze <exp_dir> [--filter-scope cell|subset|pooled]
                       (re)run the statistics pipeline over an experiment's
                       run_table.csv, writing analysis_report.{json,md} + plots;
                       --filter-scope picks the IQR strata (default `cell` =
                       model×location×length; `subset` = location×length, the
                       reference notebook's exact order, nb cells 11-13)
  recompute-energy <exp_dir> [--chips loc=n,...] [--quantize m=q,...]
                   [--trust-remote-timings]
                       recompute the modelled energy columns from the table's
                       persisted raw measurements (timings + token counts)
                       under the current energy model, then re-analyze;
                       --chips is the fallback topology and --quantize the
                       fallback per-model serving modes (model=mode with a
                       `default=` entry) for tables predating the per-row
                       `chips`/`quantize` columns; --trust-remote-timings
                       keeps such tables' multi-device remote windows as
                       measured (disables the rows-were-aliased assumption)
  prepare              validate the environment (torch, the CUDA card and its
                       NVML power limit, the kernels' build, energy channels)
  serve [opts]         start the HTTP generation server (the framework-native
                       Ollama-equivalent) over TorchEngine on the card:
                       --host H --port N (default 11434), --backend
                       torch|fake, --models a,b,c, --quantize
                       int8|int4|int4-i32|none or per-model
                       "m1=int8,default=int4", --kv-quantize int8,
                       --paged-kv (the page pool; the schedulers need it),
                       --scheduler window|continuous --window-ms W
                       --max-batch B --no-budget-admission
                       --decode-slice-steps N --prefill-chunk-tokens N
                       --ttft-slo-ms N --default-priority T
                       --preempt-policy off|swap
                       --preempt-max-wait-s S, --speculative
                       target=draft[:k] or draft[:k] (draft: a model, ngram
                       or cross:<model>; on either KV layout, the
                       contiguous one included; a speculating session
                       admits eligible joiners and preempts its rows)
                       --spec-temperature-max T --spec-draft-temperature
                       T, --spec-accept-floor F (a session whose rolling
                       acceptance drops below F halves its draft length,
                       then falls back to plain decode at k 1; a source
                       that keeps failing is not armed for a while;
                       default 0: never), --slo SPEC, --role
                       mixed|prefill|decode (a prefill server primes rows
                       for x_prime requests and ships them as migrate
                       bundles; every role serves /api/migrate and
                       /admin/evacuate), --usage-ledger-dir D,
                       --access-log, --no-telemetry, --prefix-cache N (the
                       prompt-prefix KV cache, N entries a model; 4 when N
                       is left out), --prefix-share (the shared prefix
                       store: sessions publish prompts, joiners map their
                       shared pages copy-on-write and prefill the tail)
                       --prefix-index-entries N --prefix-store-hbm-bytes B
                       --prefix-store-host-bytes B, --hf
                       model=/ckpt/dir (repeatable: that model's weights
                       and tokenizer from a local HF checkpoint's
                       *.safetensors, converted and quantized on the CPU).
                       No scheduler: one request at a time (generate and
                       generate_stream under one lock); window: concurrent
                       requests coalesce into generate_batch; continuous:
                       rows join (in prefill chunks), stream, cancel and
                       are preempted (swap: K/V to host memory; recompute:
                       dropped and re-prefilled, the contiguous session's)
                       at decode-slice granularity. The KV cache is
                       contiguous (each row in place at its own offset)
                       unless --paged-kv; the LRU guard evicts the least
                       recently used model's weights before a load that
                       would pass the card's memory (TPU_ALLOC_BUDGET_BYTES
                       sets the budget). Without a card it exits 2 (no CPU
                       fallback). Not ported, exit 2 with their ROADMAP
                       item: --backend jax|jax-tp, --tp, --dp (14),
                       --replicas > 1, --route-policy, --probe-interval-ms,
                       --roles, --model-policy, --escalate-max-tokens
                       (15)
  serve-fleet          the replica router: not ported (ROADMAP item 15), exit 2
  help                 show this message
"""


def analyze_command(
    experiment_dir: Path, filter_scope: str = "cell"
) -> None:
    """Standalone analysis pass (reference equivalent: opening the R notebook
    on run_table.csv, data-analysis/analysis-visualization.ipynb).
    ``filter_scope`` picks the IQR strata: the default ``cell`` is finer
    than the notebook's procedure; ``subset`` reproduces the notebook's
    exact order (the report header says which ran)."""
    if not (experiment_dir / "run_table.csv").exists():
        raise CommandError(f"no run_table.csv under {experiment_dir}")
    from ..analysis.pipeline import analyze_experiment

    report = analyze_experiment(
        experiment_dir, make_plots=True, filter_scope=filter_scope
    )
    term.log_ok(
        f"analysis written to {experiment_dir}/analysis_report.md "
        f"({report['n_after_iqr']}/{report['n_rows']} rows after IQR, "
        f"filter scope: {filter_scope})"
    )


def _check_card() -> None:
    """torch, the card and its power limit, and the kernels' build. Only
    the card is checked: nothing runs on the CPU in its place."""
    import torch

    term.log_ok(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        term.log_fail(
            "no CUDA device: the engine and the kernels need the card "
            "(TorchEngine raises without one unless device='cpu')"
        )
        return
    term.log_ok(
        f"CUDA device 0: {torch.cuda.get_device_name(0)} "
        f"({torch.cuda.device_count()} visible)"
    )
    from ..profilers.nvml import NvmlError, nvml_device

    try:
        dev = nvml_device()
        term.log_ok(
            f"NVML: {dev.name()}, power limit {dev.power_limit_w():.2f} W, "
            f"now {dev.power_w():.2f} W"
        )
    except NvmlError as exc:
        term.log_fail(f"NVML unavailable: {exc}")
    from ..ops import _kernels

    try:
        _kernels.build()
        term.log_ok(
            "kernels built: "
            + ", ".join(_kernels.library_path(n).name for n in _kernels.SOURCES)
        )
    except RuntimeError as exc:  # nvcc missing, or a source failed to compile
        term.log_fail(f"kernel build failed: {exc}")


def prepare() -> None:
    """Environment self-check (the reference's ``prepare`` is an empty stub,
    CLIRegister.py:77-78)."""
    term.log(f"python: {sys.version.split()[0]}")
    _check_card()
    term.log(
        "serve: `python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch serve "
        "--backend torch [--paged-kv --scheduler continuous]` serves TorchEngine on the card"
    )
    from ..profilers.energy_probe import probe_energy_channels

    # The cooldown promise is derived from the channels the study's
    # profilers actually CONSUME, not from raw probe kinds: rapl feeds
    # RaplEnergyProfiler/NativeHostProfiler and hwmon/battery feed
    # SysfsPowerProfiler (host, every mode); nvml feeds
    # NvmlEnergyProfiler and nvml_utilization NvmlDutyCycleProfiler
    # (device, in-process only). A future channel the
    # probe learns about before a profiler consumes it lands in the
    # unconsumed note below rather than inflating the promise.
    HOST_CONSUMED = {"rapl", "hwmon", "battery"}
    DEVICE_CONSUMED = {"nvml", "nvml_utilization"}
    measured_host = False
    measured_device = False
    unconsumed = []
    for status in probe_energy_channels():
        line = f"energy channel {status.name} ({status.kind}/{status.scope}): {status.detail}"
        if status.available:
            term.log_ok(line)
            if status.name in HOST_CONSUMED:
                measured_host = True
            elif status.name in DEVICE_CONSUMED:
                measured_device = True
            else:
                unconsumed.append(status.name)
        else:
            term.log_warn(line)
    if unconsumed:
        term.log_warn(
            f"channel(s) {', '.join(unconsumed)} are live but no profiler "
            "consumes them yet - they appear in energy_channels.json only "
            "and do not change the study's cooldown policy"
        )
    # The channel audit decides the study's thermal policy — say which
    # way it will go BEFORE a sweep is launched, per scope: host channels
    # (RAPL/native sampler) wire in every mode, but device channels are
    # skipped in HTTP-client mode (on_device_url), where the serving
    # process owns the card — the promise must match what
    # LlmEnergyConfig will actually do.
    from ..experiments.llm_energy import LlmEnergyConfig

    cool_measured = LlmEnergyConfig.MEASURED_CHANNEL_COOLDOWN_MS // 1000
    cool_modelled = LlmEnergyConfig.MODELLED_ONLY_COOLDOWN_MS // 1000
    if measured_host:
        term.log_ok(
            "measured HOST energy channel present - studies wire it in "
            "every mode, record real host Joules, and use the "
            f"reference's {cool_measured} s thermal cooldown"
        )
    elif measured_device:
        term.log_ok(
            "measured DEVICE energy channel present - in-process studies "
            f"wire it ({cool_measured} s thermal cooldown); a pure "
            "HTTP-client study (on_device_url set) leaves device channels "
            f"to the serving process and runs modelled-only at "
            f"{cool_modelled} s"
        )
    else:
        term.log_warn(
            "no measured energy source on this host - studies will record "
            "modelled Joules (energy_model_J), say so in "
            "energy_channels.json, and drop the cooldown to "
            f"{cool_modelled} s (modelled energy is thermal-state-free); "
            "on a host with RAPL or NVML the same study re-runs with "
            "measured Joules unchanged"
        )


def _parse_recompute(args: List[str]) -> None:
    if len(args) < 2:
        raise CommandError("recompute-energy requires an experiment directory")
    from ..experiments.llm_energy import recompute_energy

    # --chips loc=n[,loc=n...]: fallback chip map for tables from
    # before the per-row `chips` column (rows carrying the column
    # always win)
    chips = None
    quantize = None
    trust_remote_timings = False
    rest = args[2:]
    while rest:
        flag = rest[0]
        if flag == "--trust-remote-timings":
            # pre-backend-column tables only: disable the
            # remote-rows-were-aliased assumption so genuinely
            # multi-device remote measurements keep their own windows
            # (the warning recompute_energy emits names this flag's
            # library twin)
            trust_remote_timings = True
            rest = rest[1:]
            continue
        if flag == "--chips":
            if len(rest) < 2:
                raise CommandError(
                    "recompute-energy: --chips expects loc=n[,loc=n...]"
                )
            chips = {}
            for entry in rest[1].split(","):
                loc, _, count = entry.partition("=")
                if not loc or not count.isdigit():
                    raise CommandError(
                        "recompute-energy: --chips expects loc=n[,loc=n...]"
                    )
                chips[loc] = int(count)
        elif flag == "--quantize":
            if len(rest) < 2:
                raise CommandError(
                    "recompute-energy: --quantize expects "
                    "model=mode[,model=mode...]"
                )
            quantize = {}
            valid_modes = ("bf16", "int8", "int4", "int4-i32")
            for entry in rest[1].split(","):
                model, sep, mode = entry.partition("=")
                if not model or not sep or not mode:
                    raise CommandError(
                        "recompute-energy: --quantize expects "
                        "model=mode[,model=mode...]"
                    )
                # an unknown mode would silently be billed at int4 width
                # by the bytes accounting — refuse
                if mode not in valid_modes:
                    raise CommandError(
                        f"recompute-energy: unknown quantize mode "
                        f"{mode!r} for {model!r}; expected one of "
                        f"{', '.join(valid_modes)}"
                    )
                quantize[model] = mode
        else:
            raise CommandError(f"recompute-energy: unknown flag {flag!r}")
        rest = rest[2:]
    n = recompute_energy(
        Path(args[1]),
        n_chips_by_location=chips,
        quantize_by_model=quantize,
        assume_aliased_without_backend=not trust_remote_timings,
    )
    term.log_ok(
        f"recomputed modelled energy for {n} rows from their "
        f"persisted raw measurements; analysis re-run"
    )


def _not_ported(option: str, item: str) -> CommandError:
    return CommandError(f"serve: {option} is not ported to the PyTorch package yet (ROADMAP item {item})")


def _parse_quantize(spec: str):
    """``int8`` (every model), ``none``, or per model
    ``qwen2:1.5b=int8,phi3:3.8b=int4,default=int8``."""
    if "=" not in spec:
        return None if spec == "none" else spec
    quantize = {}
    for entry in spec.split(","):
        name, _, mode = entry.partition("=")
        if not name or not mode:
            raise CommandError("serve: --quantize per-model spec is model=mode[,model=mode...]")
        quantize[name] = None if mode == "none" else mode
    return quantize


def _parse_speculative(spec: str):
    """``target=draft[:k]``, or ``draft[:k]`` for every target (the
    ``default`` key); model names may hold colons, so only a trailing
    ``:<int>`` is k."""
    name, eq, rest = spec.partition("=")
    if not eq:
        name, rest = "default", spec
    head, _, tail = rest.rpartition(":")
    draft, k = (head, int(tail)) if head and tail.isdigit() else (rest, 4)
    if not spec or not name or not draft or k < 1:
        raise CommandError(
            "serve: --speculative expects target=draft[:k] or draft[:k] with k >= 1 "
            "(draft: a model name, ngram or cross:<model>)"
        )
    return name, (draft, k)


def serve_command(args: List[str]) -> None:
    """Run the generation server, the side of the study that owns the
    card (the reference's Ollama server, README.md:29-31). The option
    set is the JAX package's ``serve``; those of layers the port does not
    have yet refuse with their ROADMAP item."""
    from ..serve.protocol import DEFAULT_PORT, SERVER_ROLES, parse_priority

    opts = {
        "host": "0.0.0.0", "port": DEFAULT_PORT, "batch_window_ms": 0.0, "scheduler": None,
        "max_batch": None, "budget_aware": None, "slice_steps": None,
        "prefill_chunk_tokens": None, "ttft_slo_ms": None, "default_priority": None,
        "preempt_policy": None, "preempt_max_wait_s": None, "slo": None, "role": None,
        "usage_ledger_dir": None, "access_log": False,
    }
    backend_kind = "torch"
    models: Optional[List[str]] = None
    engine_kwargs: dict = {}
    prefix_kwargs: dict = {}  # the shared prefix store's, both backends
    speculative: dict = {}
    paged_kv = False
    it = iter(args)

    def value(flag: str) -> str:
        v = next(it, None)
        if v is None:
            raise CommandError(f"serve: {flag} expects a value")
        return v

    def number(flag: str, kind=float, low=None, strict=False):
        try:
            v = kind(value(flag))
        except ValueError:
            raise CommandError(f"serve: {flag} expects a number")
        if low is not None and (v <= low if strict else v < low):
            raise CommandError(f"serve: {flag} expects a number {'>' if strict else '>='} {low}")
        return v

    for arg in it:
        if arg == "--port":
            opts["port"] = number(arg, int, 0)
        elif arg == "--host":
            opts["host"] = value(arg)
        elif arg == "--backend":
            backend_kind = value(arg)
            if backend_kind in ("jax", "jax-tp"):
                raise CommandError(
                    f"serve: --backend {backend_kind} is the JAX package's engine; the port "
                    "serves TorchEngine (--backend torch) and its tensor-parallel engine is "
                    "not ported yet (ROADMAP item 14)"
                )
            if backend_kind not in ("torch", "fake"):
                raise CommandError(f"serve: unknown backend {backend_kind!r} (torch|fake)")
        elif arg in ("--tp", "--dp"):
            raise _not_ported(f"{arg} (tensor and data parallelism)", "14")
        elif arg == "--replicas":
            if number(arg, int, 1) > 1:
                raise _not_ported("--replicas > 1 (the replica router)", "15")
        elif arg in ("--route-policy", "--probe-interval-ms", "--roles"):
            raise _not_ported(f"{arg} (the replica router)", "15")
        elif arg in ("--model-policy", "--escalate-max-tokens"):
            raise _not_ported(f"{arg} (the multi-model fleet)", "15")
        elif arg == "--prefix-cache":
            # the solo prompt-prefix KV cache: N entries per model (the
            # JAX package's default when N is left out: 4)
            try:
                engine_kwargs["prefix_cache_size"] = int(next(it, "4"))
            except ValueError:
                raise CommandError("serve: --prefix-cache expects a number of entries")
        elif arg == "--prefix-share":
            # the engine's shared prefix store: sessions publish their
            # prompts, joiners map the shared pages and prefill the tail
            prefix_kwargs["prefix_share"] = True
        elif arg == "--prefix-index-entries":
            prefix_kwargs["prefix_index_entries"] = number(arg, int, 1)
        elif arg == "--prefix-store-hbm-bytes":
            # device-byte budget of the store: over it, cold prefix pages
            # spill to host memory
            prefix_kwargs["prefix_store_hbm_bytes"] = number(arg, int, 0)
        elif arg == "--prefix-store-host-bytes":
            # host-byte budget (spilled pages + seed slabs): over it, cold
            # leaves are evicted outright
            prefix_kwargs["prefix_store_host_bytes"] = number(arg, int, 0)
        elif arg == "--hf":
            # --hf model=/path/to/checkpoint (repeatable): serve the model's
            # weights and tokenizer from a local HF checkpoint directory
            spec = value(arg)
            if "=" not in spec:
                raise CommandError("serve: --hf expects model=/path/to/dir")
            name, _, path = spec.partition("=")
            engine_kwargs.setdefault("hf_checkpoints", {})[name] = path
        elif arg == "--models":
            models = [m for m in value(arg).split(",") if m]
        elif arg in ("--window-ms", "--batch-window-ms"):
            opts["batch_window_ms"] = number(arg, float, 0)
        elif arg == "--scheduler":
            opts["scheduler"] = value(arg)
            if opts["scheduler"] not in ("window", "continuous"):
                raise CommandError("serve: --scheduler expects 'window' or 'continuous'")
        elif arg == "--max-batch":
            opts["max_batch"] = number(arg, int, 0) or None
        elif arg == "--no-budget-admission":
            opts["budget_aware"] = False
        elif arg == "--decode-slice-steps":
            opts["slice_steps"] = number(arg, int, 0, strict=True)
        elif arg == "--prefill-chunk-tokens":
            opts["prefill_chunk_tokens"] = number(arg, int, 0, strict=True)
        elif arg == "--ttft-slo-ms":
            opts["ttft_slo_ms"] = number(arg, float, 0, strict=True)
        elif arg == "--default-priority":
            try:
                opts["default_priority"] = parse_priority(value(arg))
            except ValueError as exc:
                raise CommandError(f"serve: --default-priority: {exc}")
        elif arg == "--preempt-policy":
            opts["preempt_policy"] = value(arg)
            if opts["preempt_policy"] not in ("off", "swap", "recompute"):
                raise CommandError("serve: --preempt-policy expects 'off', 'swap' or 'recompute'")
        elif arg == "--preempt-max-wait-s":
            opts["preempt_max_wait_s"] = number(arg, float, 0)
        elif arg == "--quantize":
            engine_kwargs["quantize"] = _parse_quantize(value(arg))
        elif arg == "--kv-quantize":
            kv = value(arg)
            engine_kwargs["kv_quantize"] = None if kv == "none" else kv
        elif arg == "--paged-kv":
            paged_kv = True
        elif arg == "--speculative":
            name, draft = _parse_speculative(value(arg))
            speculative[name] = draft
        elif arg == "--spec-accept-floor":
            # a speculating session whose rolling acceptance drops under
            # this fraction shortens its draft, then falls back (0: never)
            floor = number(arg, float, 0)
            if floor >= 1.0:
                raise CommandError("serve: --spec-accept-floor expects a fraction in [0, 1)")
            engine_kwargs["spec_accept_floor"] = floor
            opts["spec_accept_floor"] = floor
        elif arg == "--spec-temperature-max":
            engine_kwargs["spec_temperature_max"] = number(arg, float, 0)
        elif arg == "--spec-draft-temperature":
            engine_kwargs["spec_draft_temperature"] = number(arg, float, 0, strict=True)
        elif arg == "--slo":
            from ..obs.slo import parse_slo_spec

            opts["slo"] = value(arg)
            try:
                parse_slo_spec(opts["slo"])
            except ValueError as exc:
                raise CommandError(f"serve: --slo: {exc}")
        elif arg == "--role":
            opts["role"] = value(arg)
            if opts["role"] not in SERVER_ROLES:
                raise CommandError("serve: --role expects one of " + "|".join(SERVER_ROLES))
        elif arg == "--usage-ledger-dir":
            opts["usage_ledger_dir"] = value(arg)
        elif arg == "--access-log":
            opts["access_log"] = True
        elif arg == "--no-telemetry":
            from ..obs import disable as obs_disable

            obs_disable()
        else:
            raise CommandError(f"serve: unrecognised option {arg!r}")

    if backend_kind == "fake":
        from ..engine.fake import FakeBackend

        backend = FakeBackend(**{k: v for k, v in prefix_kwargs.items() if k != "prefix_index_entries"})
    else:
        from ..engine.torch_engine import TorchEngine
        from ..models.config import MODEL_REGISTRY

        if models is None:
            models = sorted(MODEL_REGISTRY)
        try:
            backend = TorchEngine(
                paged_kv=paged_kv, speculative=speculative or None, **engine_kwargs, **prefix_kwargs
            )
        except (RuntimeError, ValueError) as exc:
            raise CommandError(f"serve: {exc}")
    from ..serve.server import GenerationServer

    server = GenerationServer(backend, models=models, **opts)
    _serve_until_signalled(server)


def _serve_until_signalled(server) -> None:
    """``serve_forever`` until SIGTERM or Ctrl-C, then stop the server:
    the scheduler drains its thread and fails what is still queued."""

    def on_term(signum, frame):
        raise KeyboardInterrupt

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, on_term) if main_thread else None
    try:
        server.serve_forever()
    finally:
        server.stop()
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
            term.log_ok("generation server stopped")


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("help", "--help", "-h"):
        print(HELP)
        return 0
    cmd = args[0]
    try:
        if cmd == "config-create":
            config_create(Path(args[1]) if len(args) > 1 else None)
        elif cmd == "analyze":
            if len(args) < 2:
                raise CommandError("analyze requires an experiment directory")
            scope = "cell"
            rest = args[2:]
            while rest:
                if rest[0] == "--filter-scope":
                    if len(rest) < 2 or rest[1] not in (
                        "cell",
                        "subset",
                        "pooled",
                    ):
                        raise CommandError(
                            "analyze: --filter-scope expects "
                            "cell|subset|pooled"
                        )
                    scope = rest[1]
                    rest = rest[2:]
                else:
                    raise CommandError(f"analyze: unknown flag {rest[0]!r}")
            analyze_command(Path(args[1]), filter_scope=scope)
        elif cmd == "recompute-energy":
            _parse_recompute(args)
        elif cmd == "prepare":
            prepare()
        elif cmd == "serve":
            serve_command(args[1:])
        elif cmd == "serve-fleet":
            raise CommandError(
                "serve-fleet (the replica router, serve/router.py) is not "
                "ported to the PyTorch package yet (ROADMAP item 15)"
            )
        elif cmd.endswith(".py"):
            run_config_file(Path(cmd))
        else:
            raise CommandError(f"unrecognised command: {cmd!r}\n{HELP}")
    except CommandError as exc:
        term.log_fail(str(exc))
        return 2
    except ExperimentError as exc:
        term.log_fail(f"{type(exc).__name__}: {exc}")
        return 1
    return 0
