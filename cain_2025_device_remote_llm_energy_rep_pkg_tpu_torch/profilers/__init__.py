"""Measurement plugins with a three-phase contract (start/stop/collect).

Reference: ``experiment-runner/Plugins/Profilers/`` — the CodeCarbon energy
wrapper (CodecarbonWrapper.py) — plus the inline psutil/powermetrics
sampling the reference's experiment does by hand
(experiment/RunnerConfig.py:135-178). Every sampler implements the same
:class:`~.base.Profiler` interface and is attached via the config's
``profilers`` list.

The ported profilers: the base classes, host CPU/memory, RAPL, sysfs
power, the synthetic trace, and the GPU pair of ``nvml.py`` (NVML's
measured Joules and the modelled ones). Nothing here touches the card at
import; NVML opens on first use.
"""

from .base import Profiler, SamplingProfiler
from .host import HostResourceProfiler
from .nvml import GpuEnergyModelProfiler, NvmlEnergyProfiler
from .rapl import RaplEnergyProfiler
from .synthetic import SyntheticPowerProfiler
from .sysfs_power import SysfsPowerProfiler

__all__ = [
    "Profiler",
    "SamplingProfiler",
    "HostResourceProfiler",
    "GpuEnergyModelProfiler",
    "NvmlEnergyProfiler",
    "RaplEnergyProfiler",
    "SyntheticPowerProfiler",
    "SysfsPowerProfiler",
]
