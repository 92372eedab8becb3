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
  powermetrics GPU sampling (:140)       → modelled GPU utilisation column
  psutil cpu/mem loop (:153-178)         → HostResourceProfiler thread
  random topic from topics.csv (:115)    → seeded topic per run (reproducible)
  30 reps, shuffle, 90 s cooldown (:87)  → constructor-configurable

The reference's quirks are deliberately fixed (SURVEY.md §7):
execution_time here is the request wall-time, not hook-to-hook time; the
measurement runs on profiler threads so ``interact`` genuinely waits on the
generation rather than being dead code.

Not ported yet: post-hoc energy recomputation and the analysis pipeline
(``after_experiment`` does nothing), the native host sampler (the
psutil + RAPL pair stands in, with the same columns), the per-cell CV
telemetry, a duty-cycle profiler, and a local multi-GPU mesh for
``remote``.
"""

from __future__ import annotations

import math
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
        from ..profilers.host import HostResourceProfiler
        from ..profilers.rapl import RaplEnergyProfiler
        from ..profilers.sysfs_power import SysfsPowerProfiler

        self.profilers = [
            # one model-energy profiler; per-run device count set in before_run
            GpuEnergyModelProfiler(
                n_chips=self._n_chips_by_location.get(self.locations[0], 1)
            ),
            # host cpu/memory and host energy: the psutil + RAPL pair (the
            # JAX package's native sampler falls back to it, same columns)
            HostResourceProfiler(period_s=0.2),
            RaplEnergyProfiler(),
        ]
        # Generic sysfs host power (hwmon rails / battery discharge):
        # host-scoped, so it wires in EVERY mode — a laptop whose only
        # measured channel is hwmon records real Watts instead of
        # modelled-only (and re-grows the thermal cooldown below).
        sysfs = SysfsPowerProfiler()
        if sysfs.available:
            self.profilers.insert(1, sysfs)
        # The card's energy counter only when this process owns (or will
        # own) the card; in HTTP-client mode the serving process does.
        if on_device_url is None:
            counter = NvmlEnergyProfiler()
            if counter.available:  # NVML and the card's energy counter
                self.profilers.insert(0, counter)
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

            # On the card unless none is available, and then it raises:
            # the engine never moves to the CPU by itself.
            self._backends = {"on_device": TorchEngine(quantize=self.quantize)}
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
        stats = generation_stats_from(
            cfg,
            result,
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
