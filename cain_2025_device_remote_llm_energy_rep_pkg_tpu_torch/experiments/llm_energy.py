"""The study config: on-device vs remote LLM generation energy on the H100.

Rebuilds ``experiment/RunnerConfig.py`` (the reference's L7 workload) on
the port, as the JAX package's ``experiments/llm_energy.py`` does on a
TPU:

  reference                              → this config
  ------------------------------------------------------------------
  7 Ollama models (RunnerConfig.py:80)   → same 7 families, TorchEngine
  location ∈ {on_device, remote} (:81)   → the card, or an HTTP server;
                                           without one, the card again,
                                           billed as an 8-GPU node
  length ∈ {100,500,1000} words (:82)    → max_new_tokens = ceil(words·4/3)
  curl POST /api/generate (:128-131)     → in-process GenerationRequest
  CodeCarbon kWh→J (:250-259)            → NVML energy counter + modelled J
  powermetrics GPU sampling (:140)       → NVML duty cycle + modelled utilisation
  psutil cpu/mem loop (:153-178)         → HostResourceProfiler thread
  random topic from topics.csv (:115)    → seeded topic per run (reproducible)
  30 reps, shuffle, 90 s cooldown (:87)  → constructor-configurable

The reference's quirks are deliberately fixed (SURVEY.md §7):
execution_time here is the request wall-time, not hook-to-hook time; the
measurement runs on profiler threads so ``interact`` genuinely waits on the
generation rather than being dead code.

Not ported yet: a local multi-GPU mesh for ``remote``.
"""

from __future__ import annotations

import math
import types
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..engine.backend import GenerationBackend, GenerationRequest
from ..serve.client import RemoteHTTPBackend
from ..profilers.nvml import GpuEnergyModelProfiler, NvmlEnergyProfiler
from ..runner.config import ExperimentConfig
from ..runner.context import RunContext
from ..runner.factors import Factor, RunTableModel
from .topics import pick_topic

MODELS = [
    "qwen2:1.5b",
    "gemma:2b",
    "phi3:3.8b",
    "gemma:7b",
    "qwen2:7b",
    "mistral:7b",
    "llama3.1:8b",
]
LOCATIONS = ["on_device", "remote"]
LENGTHS = [100, 500, 1000]
TOKENS_PER_WORD = 4 / 3  # common English tokens-per-word rule of thumb
# The study's serving topology: on_device = one device, remote = an
# 8-device tensor-parallel server (on the H100, an 8-GPU NVLink node).
DEFAULT_N_CHIPS_BY_LOCATION = {"on_device": 1, "remote": 8}


def _canonical_url(url: str) -> str:
    """Canonical form for same-server comparison: lowercase scheme+host,
    loopback spellings unified, default port explicit, trailing slash
    stripped — ``http://localhost:11434/`` and ``http://127.0.0.1:11434``
    are one server (and one chip), and missing that reintroduces the
    unmarked-aliasing bug this detection exists for."""
    from urllib.parse import urlsplit

    parts = urlsplit(url.strip().rstrip("/"))
    host = (parts.hostname or "").lower()
    if host in ("localhost", "::1", "0.0.0.0"):
        host = "127.0.0.1"
    port = parts.port or (443 if parts.scheme == "https" else 80)
    return f"{parts.scheme.lower()}://{host}:{port}"



def generation_stats_from(
    cfg,
    result,
    quantize: Optional[str] = "int8",
    kv_quantize: Optional[str] = None,
    n_chips: int = 1,
    aliased: bool = False,
) -> Dict[str, Any]:
    """The energy model's inputs for one generation, from the engine's
    raw measurements (a pure function of persisted columns, so modelled
    energy is recomputable post-hoc — the reference likewise derives its
    J column from raw data after the fact, RunnerConfig.py:250-259).

    Window choice: the idle-power window is the fence-timed DECODE loop
    only. ``prefill_s`` can be dominated by host→device dispatch latency
    — transport jitter, not device work, which the run-to-run variance
    target requires keeping out of Joules. Prefill's compute is charged
    through the FLOPs term instead (all processed tokens, prompt +
    generated). total_s remains the recorded ``execution_time_s`` — the
    reference's client-observed metric.

    ``bytes`` is the decode loop's HBM traffic (weights + KV streamed
    every step, utils/memory.estimate_decode_read_bytes_per_step under
    the serving ``quantize`` mode) — the memory-bound half of the power
    model's duty cycle.

    ``aliased`` marks a remote-treatment row actually measured on the
    single on-device chip (single-chip dev hosts; the run table's
    ``backend`` column records this per row). For those rows the serving
    mesh's decode DURATION is modelled by the TP roofline
    (parallel/roofline.py) — an 8-chip mesh decodes materially faster
    than one chip, and billing 8 chips for the single chip's wall time
    would invert the reference's speed-vs-energy trade-off. The modelled window is returned as
    ``modeled_decode_s`` and used as ``duration_s``; the measured
    single-chip timing stays in the raw ``decode_s`` column untouched.
    """
    total_tokens = result.prompt_tokens + result.generated_tokens
    flops = (
        cfg.flops_per_token(total_tokens) * total_tokens
        if cfg is not None
        else 0.0
    )
    duration = result.decode_s if result.decode_s > 0 else result.total_s
    stats: Dict[str, Any] = {
        "flops": flops,
        "duration_s": duration,
        "generated_tokens": result.generated_tokens,
    }
    if cfg is None:
        if aliased and n_chips > 1:
            from ..runner import term

            model = getattr(getattr(result, "request", None), "model", "?")
            term.log_warn(
                f"model {model!r} not in the "
                f"registry: the aliased remote row keeps the single-chip "
                f"measured window and a FLOPs-free energy model (idle "
                f"watts) — pass the study's registry for honest mesh "
                f"columns"
            )
    else:
        from ..utils.memory import (
            decode_kv_stream_bytes,
            decode_weight_stream_bytes,
        )

        mid_context = int(result.prompt_tokens + result.generated_tokens / 2)
        # Mesh KV replication (parallel/sharding.py): when n_kv_heads does
        # not divide the mesh, EVERY chip streams the full cache — total
        # mesh traffic is W + n·KV, and the duty denominator already
        # scales by n_chips, so bytes must too (the roofline duration
        # model applies the same rule per chip).
        kv_mult = (
            n_chips
            if n_chips > 1 and cfg.n_kv_heads % n_chips != 0
            else 1
        )
        stats["bytes"] = (
            decode_weight_stream_bytes(cfg, quantize)
            + kv_mult
            * decode_kv_stream_bytes(
                cfg, mid_context, kv_quantize=kv_quantize
            )
        ) * result.generated_tokens
        # weight-unpack work (CUDA-core ops on the H100,
        # utils/memory.py); on a TP mesh each device unpacks its own
        # weight shard, so total ops don't scale with chips
        from ..utils.memory import decode_vpu_unpack_ops_per_step

        stats["vpu_ops"] = (
            decode_vpu_unpack_ops_per_step(cfg, quantize)
            * result.generated_tokens
        )
        if aliased and n_chips > 1:
            from ..parallel.roofline import modeled_tp_decode_s

            # The roofline supplies the 1-chip → n-chip RATIO only; the
            # absolute window is anchored on the row's own measured
            # single-chip decode. Reason: a real access pattern sustains
            # well under the roofline's memory rate, so raw roofline
            # seconds would understate the mesh time and overstate the
            # speedup past n_chips×; scaling
            # the measurement by the modelled ratio keeps the workload's
            # real efficiency and bounds the speedup by the model's own
            # sublinear link accounting.
            t1 = modeled_tp_decode_s(
                cfg,
                quantize,
                1,
                result.prompt_tokens,
                result.generated_tokens,
                kv_quantize=kv_quantize,
            )
            tn = modeled_tp_decode_s(
                cfg,
                quantize,
                n_chips,
                result.prompt_tokens,
                result.generated_tokens,
                kv_quantize=kv_quantize,
            )
            if t1 > 0 and tn > 0 and duration > 0:
                if tn >= t1:
                    # Physically honest — per-layer all-reduces sit on
                    # the link latency floor, so toy/tiny models DO
                    # decode slower on a mesh — but a study billing mesh
                    # windows slower than one chip is almost certainly
                    # misconfigured (e.g. tiny test models with the real
                    # 8-device topology).
                    from ..runner import term

                    term.log_warn(
                        f"TP-{n_chips} roofline predicts a SLOWDOWN "
                        f"({t1 / tn:.2f}× speedup) for this workload - "
                        f"the mesh window is being billed honestly, but "
                        f"check the topology fits the model scale "
                        f"(n_chips_by_location)"
                    )
                modeled = duration * (tn / t1)
                stats["modeled_decode_s"] = round(modeled, 4)
                stats["duration_s"] = modeled
    return stats


def recompute_energy(
    experiment_dir: Path,
    n_chips_by_location: Optional[Dict[str, int]] = None,
    registry: Optional[Dict[str, Any]] = None,
    reanalyze: bool = True,
    quantize_by_model: Optional[Dict[str, str]] = None,
    assume_aliased_without_backend: bool = True,
) -> int:
    """Recompute the modelled energy columns of an existing run table from
    its persisted RAW measurements (timings + token counts) under the
    current energy model — the post-hoc derived-column pattern the
    reference itself uses (``energy_usage_J``, RunnerConfig.py:250-259).
    Raw measurements are never touched. Returns the number of rows
    updated; re-runs the analysis pipeline by default.

    The serving-chip count comes from each row's persisted ``chips``
    column; tables from before that column existed fall back to
    ``n_chips_by_location`` (default: the study's standard topology,
    ``DEFAULT_N_CHIPS_BY_LOCATION``) — pass the map the study actually
    ran with if it was customised. The quantization mode comes from the
    row's ``quantize`` column; for older tables without it,
    ``quantize_by_model`` supplies the serving modes (the serve CLI's
    per-model spec shape: ``{"qwen2:1.5b": "int8", "default": "int4"}``),
    falling back to the study default ``"int8"`` — and the resolved mode
    is BACKFILLED into the ``quantize`` column so the table becomes
    self-contained for future recomputes. A row whose ``backend`` column carries
    the ``[aliased-on_device]`` marker (or, for pre-backend-column
    tables, any remote row served by >1 chip — aliasing was the only way
    such a row could exist then, and how many rows took that ASSUMPTION
    is warned about, since a genuinely multi-chip remote measurement fed
    through it would have its window silently rewritten; pass
    ``assume_aliased_without_backend=False`` for tables known to carry
    real remote measurements) gets the TP-roofline
    modelled duration as its energy window and a
    ``remote_modeled_decode_s`` column (see ``generation_stats_from``). ``registry`` maps model name →
    ModelConfig for the FLOPs term (default: the full-size
    ``MODEL_REGISTRY``; pass the study's own registry for tables produced
    with custom/miniature configs)."""

    from ..models.config import MODEL_REGISTRY
    from ..runner.persistence import RunTableStore

    fallback_chips = dict(n_chips_by_location or DEFAULT_N_CHIPS_BY_LOCATION)
    configs = registry if registry is not None else MODEL_REGISTRY
    store = RunTableStore(Path(experiment_dir))
    rows = store.read()
    # Aliasing detection needs cross-row context: a remote row whose
    # backend ALSO serves on_device rows came from a shared single-chip
    # process (the loopback-server capstone records the same URL for
    # both treatments), even without the [aliased-on_device] marker the
    # in-process alias appends. HTTP backend strings are canonicalized
    # before comparison — localhost vs 127.0.0.1 is one server.
    def _canonical_backend(desc: str) -> str:
        if desc.startswith("http:"):
            try:
                return "http:" + _canonical_url(desc[len("http:"):])
            except ValueError:
                return desc
        return desc

    on_device_backends = {
        _canonical_backend(str(r.get("backend")))
        for r in rows
        if str(r.get("location")) == "on_device" and r.get("backend")
    }
    updated = 0
    assumed_aliased = 0
    for row in rows:
        # uniform keys: RunTableStore.write derives the header from the
        # first row, so every row must carry the new columns
        row.setdefault("remote_modeled_decode_s", None)
        row.setdefault("chips", None)
        for col in GpuEnergyModelProfiler.data_columns:
            row.setdefault(col, None)
        if quantize_by_model:
            row.setdefault("quantize", None)
        # every raw input the model consumes must be present — a legacy
        # table missing any one of them skips the row, never aborts the
        # whole recompute
        if any(
            row.get(k) is None
            for k in (
                "decode_s",
                "generated_tokens",
                "prompt_tokens",
                "execution_time_s",
            )
        ):
            continue
        cfg = configs.get(str(row.get("model")))
        result = types.SimpleNamespace(
            prompt_tokens=int(row["prompt_tokens"]),
            generated_tokens=int(row["generated_tokens"]),
            decode_s=float(row["decode_s"]),
            total_s=float(row["execution_time_s"]),
            # the unknown-model warning names the row's model through the
            # same attribute path interact's real result provides
            request=types.SimpleNamespace(model=str(row.get("model"))),
        )
        chips = row.get("chips")
        n_chips = (
            int(chips)
            if chips is not None
            else fallback_chips.get(str(row.get("location")), 1)
        )
        # Backfill the chips column ONLY from an operator-asserted map:
        # baking the built-in default into the table would make a later
        # `--chips remote=4` recompute a silent no-op (rows carrying the
        # column always win), turning a recoverable omission into a
        # frozen wrong topology.
        if chips is None and n_chips_by_location is not None:
            row["chips"] = n_chips
        backend = row.get("backend")
        is_remote = str(row.get("location")) == "remote"
        if backend is not None:
            aliased = str(backend).endswith("[aliased-on_device]") or (
                is_remote
                and _canonical_backend(str(backend)) in on_device_backends
            )
        else:
            # pre-backend-column table: aliasing was the only way a
            # multi-chip remote row could exist then — but it is an
            # ASSUMPTION here, counted and warned about below
            aliased = (
                assume_aliased_without_backend and is_remote and n_chips > 1
            )
            if aliased:
                assumed_aliased += 1
        # persisted as "bf16" for unquantized serving (CSV cannot
        # distinguish None from a missing pre-column cell); missing →
        # the caller's per-model map, then the study default int8
        q = row.get("quantize")
        if not q and quantize_by_model:
            q = quantize_by_model.get(
                str(row.get("model")), quantize_by_model.get("default")
            )
            row["quantize"] = q or "int8"
        stats = generation_stats_from(
            cfg,
            result,
            quantize=None if q == "bf16" else (q or "int8"),
            n_chips=n_chips,
            aliased=aliased,
        )
        profiler = GpuEnergyModelProfiler(n_chips=n_chips)
        ctx = types.SimpleNamespace(scratch={"generation_stats": stats})
        row.update(profiler.collect(ctx))
        row["remote_modeled_decode_s"] = stats.get("modeled_decode_s")
        updated += 1
    if assumed_aliased:
        from ..runner import term

        term.log_warn(
            f"{assumed_aliased} remote row(s) predate the backend column "
            f"and were ASSUMED aliased (single-chip measurement of a "
            f"multi-chip treatment): their energy window is the "
            f"TP-roofline modelled mesh duration, not their measured "
            f"decode_s. If this table came from a genuinely multi-chip "
            f"remote server, re-run with "
            f"assume_aliased_without_backend=False"
        )
    if updated:
        # one atomic whole-table rewrite, not one per row (update_row
        # re-reads and rewrites the full CSV each call — O(n²) here)
        store.write(rows)
    if reanalyze and updated:
        from ..analysis.pipeline import analyze_experiment

        analyze_experiment(Path(experiment_dir), make_plots=True)
    return updated


class LlmEnergyConfig(ExperimentConfig):
    """7 models × 2 locations × 3 content lengths × repetitions."""

    name = "llm_energy_cuda"
    results_output_path = Path("experiments_output")
    # Cooldown policy (reference: fixed 90 s, RunnerConfig.py:55): thermal
    # discipline only matters when a MEASURED energy/power channel is
    # active — a hot card throttles and skews real Joules. Modelled energy
    # is thermal-state-free, so measured-channel hosts keep the reference's
    # 90 s and modelled-only hosts drop to 2 s. ``cooldown_ms`` overrides.
    MEASURED_CHANNEL_COOLDOWN_MS = 90_000
    MODELLED_ONLY_COOLDOWN_MS = 2_000
    time_between_runs_in_ms = MEASURED_CHANNEL_COOLDOWN_MS
    # Generation happens in-process, and a forked child cannot use CUDA
    # once the parent has, so the engine lives in the parent.
    isolate_runs = False

    def __init__(
        self,
        models: Optional[List[str]] = None,
        locations: Optional[List[str]] = None,
        lengths: Optional[List[int]] = None,
        repetitions: int = 30,
        results_output_path: Optional[Path] = None,
        cooldown_ms: Optional[int] = None,
        backends: Optional[Dict[str, GenerationBackend]] = None,
        remote_url: Optional[str] = None,
        on_device_url: Optional[str] = None,
        shuffle: bool = True,
        seed: int = 0,
        n_chips_by_location: Optional[Dict[str, int]] = None,
        quantize: Optional[str] = "int8",
    ) -> None:
        self.models = models or MODELS
        self.locations = locations or LOCATIONS
        self.lengths = lengths or LENGTHS
        self.repetitions = repetitions
        self.shuffle = shuffle
        self.seed = seed
        # int8 by default: the reference's baseline models are Ollama 4-bit
        # GGUF quants, so quantized serving is the matching configuration.
        # None = full bf16.
        self.quantize = quantize
        if results_output_path is not None:
            self.results_output_path = Path(results_output_path)
        self._cooldown_ms = cooldown_ms  # None → decided by channel type below
        self._backends = backends  # None → built lazily in before_experiment
        self._remote_url = remote_url
        # The reference's on-device treatment ALSO crosses a process+HTTP
        # boundary — curl to the local Ollama on localhost:11434
        # (experiment/RunnerConfig.py:122-131). With on_device_url set, this
        # study does the faithful equivalent: a separate serving process
        # owns the card and the experiment process is a pure HTTP client
        # for both treatments.
        self._on_device_url = on_device_url
        # Plain data, deliberately NOT read back from the profiler object:
        # the shared profiler's n_chips is mutated per run in before_run, and
        # reading the target count from any aliased profiler instance would
        # let one remote run permanently poison every later on_device run.
        self._n_chips_by_location = dict(
            n_chips_by_location or DEFAULT_N_CHIPS_BY_LOCATION
        )
        from ..profilers.native_host import NativeHostProfiler
        from ..profilers.sysfs_power import SysfsPowerProfiler

        self.profilers = [
            # one model-energy profiler; per-run device count set in before_run
            GpuEnergyModelProfiler(
                n_chips=self._n_chips_by_location.get(self.locations[0], 1)
            ),
            # C++ kHz sampler for host energy/cpu/memory; it transparently
            # falls back to the psutil+RAPL Python pair (same columns) when
            # the native library can't build or load at runtime
            NativeHostProfiler(period_us=1000),
        ]
        # Generic sysfs host power (hwmon rails / battery discharge):
        # host-scoped, so it wires in EVERY mode — a laptop whose only
        # measured channel is hwmon records real Watts instead of
        # modelled-only (and re-grows the thermal cooldown below).
        sysfs = SysfsPowerProfiler()
        if sysfs.available:
            self.profilers.insert(1, sysfs)
        # The card's energy counter and duty cycle only when this process
        # owns (or will own) the card; in HTTP-client mode the serving
        # process does.
        if on_device_url is None:
            from ..profilers.energy_probe import NvmlDutyCycleProfiler

            counter = NvmlEnergyProfiler()
            if counter.available:  # NVML and the card's energy counter
                self.profilers.insert(0, counter)
            duty = NvmlDutyCycleProfiler()
            if duty.available:  # NVML's utilization rates of the card
                self.profilers.insert(0, duty)
        # Cooldown by channel type (see the class attributes): explicit
        # cooldown_ms always wins; otherwise a measured energy/power
        # channel re-grows the reference's 90 s thermal discipline.
        if self._cooldown_ms is not None:
            self.time_between_runs_in_ms = self._cooldown_ms
        else:
            self.time_between_runs_in_ms = (
                self.MEASURED_CHANNEL_COOLDOWN_MS
                if any(
                    getattr(p, "measured_channel", False)
                    for p in self.profilers
                )
                else self.MODELLED_ONLY_COOLDOWN_MS
            )

    # -- run table ------------------------------------------------------------
    def create_run_table_model(self) -> RunTableModel:
        return RunTableModel(
            factors=[
                Factor("model", self.models),
                Factor("location", self.locations),
                Factor("length", self.lengths),
            ],
            repetitions=self.repetitions,
            data_columns=[
                "topic",
                "backend",  # which backend/transport really served this row
                "chips",  # serving-chip count the energy model used — the
                # modelled columns stay recomputable from the row alone
                "quantize",  # serving quantization mode ("bf16" = none) —
                # the bytes term of the energy model depends on it
                "prompt_tokens",
                "generated_tokens",
                "execution_time_s",
                "prefill_s",
                "decode_s",
                "tokens_per_s",
                # TP-roofline modelled mesh decode window for remote rows
                # measured on an aliased single chip (None otherwise) —
                # the energy window those rows were billed on
                "remote_modeled_decode_s",
            ],
            shuffle=self.shuffle,
            shuffle_seed=self.seed,
        )

    # -- lifecycle ------------------------------------------------------------
    def before_experiment(self) -> None:
        from ..profilers.native_host import NativeHostProfiler

        for p in self.profilers:
            if isinstance(p, NativeHostProfiler):
                p.prepare()  # its build must not land in NVML's first window
        # Audit trail for the energy columns: which measured channels this
        # host offers and why the unavailable ones are unavailable (a
        # modelled-only table must say so).
        if self.experiment_path is not None:
            from ..profilers.energy_probe import write_probe_report
            from ..runner import term

            statuses = write_probe_report(
                Path(self.experiment_path) / "energy_channels.json",
                include_device=self._on_device_url is None,
            )
            measured = [s.name for s in statuses if s.available]
            term.log(
                "energy channels: "
                + (
                    f"measured sources available: {', '.join(measured)}"
                    if measured
                    else "no measured source on this host - energy columns "
                    "are modelled (see energy_channels.json)"
                )
            )
        if self._backends is None:
            if self._on_device_url:
                on_device: GenerationBackend = RemoteHTTPBackend(
                    self._on_device_url
                )
                if not on_device.health():
                    from ..runner.errors import ExperimentError

                    raise ExperimentError(
                        f"on-device generation server unreachable at "
                        f"{self._on_device_url}; start one that owns the "
                        f"card before this client process starts"
                    )
                self._backends = {"on_device": on_device}
                self._wire_remote_backend()
                return
            from ..engine.torch_engine import TorchEngine
            from ..serve.client import backend_from_env

            # On the card unless none is available, and then it raises:
            # the engine never moves to the CPU by itself. A study whose
            # only location is a remote server builds no engine here.
            self._backends = {}
            if "on_device" in self.locations or not (self._remote_url or backend_from_env()):
                self._backends["on_device"] = TorchEngine(quantize=self.quantize)
            self._wire_remote_backend()

    def _wire_remote_backend(self) -> None:
        """Choose the remote treatment's backend: an HTTP server named by
        ``remote_url`` / ``.env SERVER_IP`` (the reference's machine
        boundary, experiment/RunnerConfig.py:122-131), else the on-device
        backend aliased and *recorded as aliased* in the run table's
        backend column."""
        if "remote" not in self.locations:
            return
        from ..serve.client import backend_from_env

        http_backend = (
            RemoteHTTPBackend(self._remote_url)
            if self._remote_url
            else backend_from_env()
        )
        if http_backend is not None:
            # Fail fast on an unreachable server rather than hours into
            # the sweep.
            if not http_backend.health():
                from ..runner.errors import ExperimentError

                raise ExperimentError(
                    f"remote generation server unreachable at "
                    f"{http_backend.base_url} (from remote_url / "
                    f"SERVER_IP); start one or unset the variable to "
                    f"alias the on-device backend"
                )
            self._backends["remote"] = http_backend
            return
        # single-card host: the remote treatment still runs against the
        # on-device backend, distinguished by the energy model's device
        # count — and the aliasing is recorded per row (describe_backend),
        # so no reader can mistake these rows for a real machine boundary.
        self._backends["remote"] = self._backends["on_device"]

    def _remote_is_aliased(self) -> bool:
        """True when the remote treatment is served by the SAME backing
        process/chip as on_device: either the backend object is literally
        shared, or both are HTTP clients of one URL (the single-chip
        capstone topology: one loopback server, two treatments). Aliased
        rows get the TP-roofline mesh duration; a genuinely distinct
        remote server keeps its own measured timing."""
        remote = self._backends.get("remote")
        on_device = self._backends.get("on_device")
        if remote is None or on_device is None:
            return False
        if remote is on_device:
            return True
        return (
            isinstance(remote, RemoteHTTPBackend)
            and isinstance(on_device, RemoteHTTPBackend)
            and _canonical_url(remote.base_url)
            == _canonical_url(on_device.base_url)
        )

    def describe_backend(self, location: str) -> str:
        """Human/machine-readable identity of the backend that serves
        ``location``'s rows — recorded per run in the ``backend`` column
        (VERDICT.md round-1 weakness 3: fallback rows must be
        distinguishable)."""
        be = self._backends[location]
        if isinstance(be, RemoteHTTPBackend):
            desc = f"http:{be.base_url}"
        else:
            n = getattr(be, "n_devices", 1)
            desc = f"{type(be).__name__}[{n}chip]"
        if location == "remote" and self._remote_is_aliased():
            desc += "[aliased-on_device]"
        return desc

    def before_run(self, context: RunContext) -> None:
        location = context.factor("location")
        self.profilers[self._model_profiler_index()].n_chips = (
            self._n_chips_by_location.get(location, 1)
        )

    def _model_profiler_index(self) -> int:
        for i, p in enumerate(self.profilers):
            if isinstance(p, GpuEnergyModelProfiler):
                return i
        raise RuntimeError("GpuEnergyModelProfiler missing from profilers")

    def start_run(self, context: RunContext) -> None:
        # Seed the topic from the run id so resume re-issues the same prompt
        # (the reference draws an unseeded random topic, RunnerConfig.py:118).
        # crc32, not hash(): str hashing is salted per interpreter, which
        # would break cross-process reproducibility.
        import zlib

        topic_seed = zlib.crc32(f"{self.seed}|{context.run_id}".encode())
        topic = pick_topic(seed=topic_seed)
        words = context.factor("length")
        context.scratch["request"] = GenerationRequest(
            model=context.factor("model"),
            prompt=f"In {words} words, please give me information about {topic}",
            max_new_tokens=math.ceil(words * TOKENS_PER_WORD),
            temperature=0.0,
            seed=self.seed,
        )
        context.scratch["topic"] = topic
        backend = self._backends[context.factor("location")]
        backend.load_model(context.factor("model"))  # weights load outside window
        # Warm up outside the window too: the reference's server is warm
        # when curl fires; the kernels' build and PyTorch's first-call
        # caches inside the measured region would dominate the first run
        # of every (model, length) cell.
        backend.warmup(context.scratch["request"])

    def interact(self, context: RunContext) -> None:
        """The measured activity: one generation request (the measurement
        window is already open — profilers started in START_MEASUREMENT)."""
        backend = self._backends[context.factor("location")]
        request: GenerationRequest = context.scratch["request"]
        result = backend.generate(request)
        context.scratch["result"] = result
        # Architecture comes from the local registry, not the backend: an
        # HTTP backend has no registry, but the FLOPs estimate (→ modelled
        # utilisation/energy of the serving chips) must not degrade to idle.
        registry = getattr(backend, "registry", None)
        cfg = registry.get(request.model) if registry else None
        if cfg is None:
            from ..models.config import MODEL_REGISTRY

            cfg = MODEL_REGISTRY.get(request.model)
        location = context.factor("location")
        # Bill on the timings as the run table persists them (rounded to
        # 4 decimals in populate_run_data): recompute_energy then
        # reproduces the modelled columns from the table exactly.
        billed = types.SimpleNamespace(
            prompt_tokens=result.prompt_tokens,
            generated_tokens=result.generated_tokens,
            decode_s=round(result.decode_s, 4),
            total_s=round(result.total_s, 4),
            request=result.request,
        )
        stats = generation_stats_from(
            cfg,
            billed,
            quantize=self.quantize,
            n_chips=self._n_chips_by_location.get(location, 1),
            aliased=location == "remote" and self._remote_is_aliased(),
        )
        context.scratch["generation_stats"] = stats

    def populate_run_data(self, context: RunContext) -> Optional[Dict[str, Any]]:
        result = context.scratch.get("result")
        if result is None:
            return None
        # Per-run artifact: the generated text itself (the reference keeps
        # raw measurement artifacts per run dir; the generation is this
        # study's raw output, and with trained weights it is readable).
        try:
            (context.run_dir / "generation.txt").write_text(
                f"prompt: {result.request.prompt}\n---\n{result.text}\n"
            )
        except OSError:
            pass
        # Streaming per-cell CV (obs/detect.py): fold this run's modelled
        # J and wall time into the (model, length, location) cell's
        # Welford tracker, so the study's <=5% CV target is observable
        # MID-STUDY (llm_run_cell_cv gauges; a breaching cell fires an
        # anomaly flight event) instead of post-hoc. Telemetry only —
        # must never fail a run.
        try:
            from ..obs.detect import CELL_CV
            from ..obs.energy import estimate_from_stats

            location = context.factor("location")
            est = estimate_from_stats(
                context.scratch.get("generation_stats") or {},
                n_chips=self._n_chips_by_location.get(location, 1),
            )
            CELL_CV.observe_run(
                model=context.factor("model"),
                length=context.factor("length"),
                location=location,
                energy_J=est["J"] if est else None,
                wall_s=result.total_s,
            )
        except Exception:  # noqa: BLE001
            pass
        return {
            "topic": context.scratch["topic"],
            "backend": self.describe_backend(context.factor("location")),
            "chips": self._n_chips_by_location.get(
                context.factor("location"), 1
            ),
            "quantize": self.quantize or "bf16",
            "prompt_tokens": result.prompt_tokens,
            "generated_tokens": result.generated_tokens,
            "execution_time_s": round(result.total_s, 4),
            "prefill_s": round(result.prefill_s, 4),
            "decode_s": round(result.decode_s, 4),
            "tokens_per_s": round(result.tokens_per_s, 2),
            "remote_modeled_decode_s": context.scratch[
                "generation_stats"
            ].get("modeled_decode_s"),
        }

    def after_experiment(self) -> None:
        # The reference appends a derived J column post-hoc
        # (RunnerConfig.py:250-259); here the analysis pipeline computes
        # everything from the persisted table.
        if self.experiment_path and (self.experiment_path / "run_table.csv").exists():
            from ..analysis.pipeline import analyze_experiment

            try:
                analyze_experiment(
                    self.experiment_path,
                    # metrics auto-detect from the table (KNOWN_METRIC_COLUMNS
                    # order): a fixed list here silently EXCLUDED measured
                    # channels — a host with a live power counter would have
                    # had its gpu_energy_J column ignored by the study's own
                    # post-hoc analysis while the pipeline's
                    # measured-outranks-model selection sat unused
                    metrics=None,
                    # the notebook's figure families are part of the study's
                    # deliverable (nb cells 21-28, 39-40), not an opt-in
                    make_plots=True,
                )
            except Exception as exc:  # analysis must never lose run data
                from ..runner import term

                term.log_warn(f"post-hoc analysis failed: {exc}")
