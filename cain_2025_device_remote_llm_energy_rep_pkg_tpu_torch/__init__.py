"""PyTorch/CUDA port of the LLM-energy framework, for one NVIDIA H100.

The JAX package ``cain_2025_device_remote_llm_energy_rep_pkg_tpu`` stays the
reference; this package mirrors its module names so that each port module
has a counterpart to be held against. It imports ``torch`` and numpy, never
``jax`` and never the JAX package.

- ``runner``      — the experiment kernel: factorial run tables, lifecycle
                    event bus, config-as-code contract, atomic CSV
                    persistence, AST-hash resume, per-run process isolation
                    (copies), and the command line (``runner/cli.py``).
- ``profilers``   — three-phase measurement plugins: NVML's measured GPU
                    Joules and the modelled ones (``nvml.py``), the native
                    host sampler (``native_host.py`` over ``native/``),
                    host CPU/memory, RAPL, sysfs power, synthetic; the
                    energy channel probe.
- ``experiments`` — the study config (``llm_energy.py``): 7 models × 2
                    locations × 3 lengths, one measured run per row, its
                    post-hoc analysis and energy recompute.
- ``analysis``    — the statistics pipeline over ``run_table.csv``
                    (descriptives, Wilcoxon, Cliff's delta, Spearman,
                    report and plots; copies, the port's column names).
- ``native``      — the C++ host sampler, built with g++ at first use.
- ``serve``       — the wire protocol and the HTTP client backend (the
                    study's remote treatment when a server is named).
- ``obs``         — metrics registry, span tracer, tenant accounting, the
                    flight recorder, anomaly detection and live energy
                    attribution (copies; ``energy.py`` on the H100 model).
- ``models``      — config registry, tokenizers, int8 quantization, the
                    decoder-only transformer over stacked ``[L, ...]``
                    weights, and the numpy bridge from the JAX package's
                    params.
- ``ops``         — RoPE, RMSNorm, sampling, the plain attention versions and
                    the hand-written Hopper kernels (``csrc/``).
- ``engine``      — the generation contract and ``TorchEngine``, whose
                    ``generate`` is the study's measured path.
- ``parallel``    — the tensor-parallel decode roofline (H100 constants).
- ``utils``       — ``.env`` loading and the weight/decode byte model.

The package root imports only the hardware-free experiment kernel. Entry
points run on the card unless the caller asks for the CPU. The command
line is ``python -m cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch``
(``help`` lists its commands).
"""

__version__ = "0.1.0"

from .runner.config import ExperimentConfig, OperationType
from .runner.context import RunContext
from .runner.events import EventBus, LifecycleEvent
from .runner.factors import Factor, RunTableModel
from .runner.progress import RunProgress

__all__ = [
    "ExperimentConfig",
    "OperationType",
    "RunContext",
    "EventBus",
    "LifecycleEvent",
    "Factor",
    "RunTableModel",
    "RunProgress",
    "__version__",
]
