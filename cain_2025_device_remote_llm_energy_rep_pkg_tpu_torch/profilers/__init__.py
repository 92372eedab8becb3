"""Measurement plugins with a three-phase contract (start/stop/collect).

Reference: ``experiment-runner/Plugins/Profilers/`` — the CodeCarbon energy
wrapper (CodecarbonWrapper.py) — plus the inline psutil/powermetrics
sampling the reference's experiment does by hand
(experiment/RunnerConfig.py:135-178). Every sampler implements the same
:class:`~.base.Profiler` interface and is attached via the config's
``profilers`` list.

The ported profilers: the base classes, host CPU/memory, RAPL, sysfs
power, the synthetic trace, the serial wall-power meter, the GPU pair of
``nvml.py`` (NVML's measured Joules and the modelled ones), NVML's duty
cycle (``energy_probe.py``), the per-run ``torch.profiler`` trace and the
host span trace. Nothing here touches the card at import; NVML opens on
first use.
"""

from .base import Profiler, SamplingProfiler
from .energy_probe import NvmlDutyCycleProfiler
from .host import HostResourceProfiler
from .nvml import GpuEnergyModelProfiler, NvmlEnergyProfiler
from .rapl import RaplEnergyProfiler
from .serial_power import SerialPowerMeterProfiler
from .span_trace import SpanTraceProfiler
from .synthetic import SyntheticPowerProfiler
from .sysfs_power import SysfsPowerProfiler
from .torch_trace import TorchTraceProfiler

__all__ = [
    "Profiler",
    "SamplingProfiler",
    "HostResourceProfiler",
    "GpuEnergyModelProfiler",
    "NvmlDutyCycleProfiler",
    "NvmlEnergyProfiler",
    "RaplEnergyProfiler",
    "SerialPowerMeterProfiler",
    "SpanTraceProfiler",
    "SyntheticPowerProfiler",
    "SysfsPowerProfiler",
    "TorchTraceProfiler",
]
