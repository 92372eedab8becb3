"""NVIDIA GPU energy profilers: NVML's measured Joules beside modelled ones.

The counterpart of the JAX package's ``profilers/tpu.py``, for the H100:

- :class:`NvmlEnergyProfiler` reads the card's own energy counter through
  NVML (``libnvidia-ml.so.1``, bound with ctypes: no Python NVML package
  is needed). Its Joules are the counter's difference across the
  measurement window (``nvmlDeviceGetTotalEnergyConsumption``, mJ); its
  mean power comes from power samples taken on a thread
  (``nvmlDeviceGetPowerUsage``, mW). Measured, so it drives the study's
  thermal cooldown.
- :class:`GpuEnergyModelProfiler` is the deterministic model: the
  workload records its FLOPs, device-memory bytes, unpack ops and window
  in ``context.scratch['generation_stats']``, and power is the additive
  per-engine sum ``P = P_idle + d_tc·W_tc + d_hbm·W_hbm + d_cc·W_cc``,
  clamped to the card's limit, each duty the engine's achieved rate over
  its data-sheet rate. Its column is ``energy_model_J``, so modelled
  Joules are never confused with measured ones.

The engine's CUDA device is found in NVML by its PCI bus id: the CUDA and
NVML numberings differ under ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Dict, List, Optional

from ..runner.context import RunContext
from .base import Profiler, SamplingProfiler, integrate_power_to_joules

NVML_LIB = "libnvidia-ml.so.1"

# NVIDIA H100 Tensor Core GPU data sheet, SXM column: 989 TFLOP/s dense
# bf16 on the tensor cores (1,979 with sparsity), 3.35 TB/s of HBM3, a
# configurable power limit of up to 700 W, and 67 TFLOP/s FP32 on the CUDA
# cores (the non-tensor rate). Duties are achieved rates over these.
H100_PEAK_BF16_TFLOPS = 989.0
H100_SPEC_HBM_GBPS = 3350.0
H100_PEAK_W = 700.0
# The weight-unpack term (``vpu_ops`` in the stats: nibble and int8
# converts, ``utils/memory.py``) runs on the CUDA cores, so it is billed
# against the data sheet's non-tensor rate, one unpack op as one of its
# operations.
H100_CUDA_CORE_OPS_PER_S = 67.0e12

# The watts below are MODELLED and UNCALIBRATED: no data-sheet figure
# exists for them, nothing was fitted to the card, and each carries a
# derivation and a bound. A recalibration against NVML (this module's
# measured profiler) is a visible, deliberate change of these numbers and
# of their test. Until then ``energy_model_J`` is a model's figure, not a
# measurement's stand-in.
#
# - Idle: no published source. The figure is an assumption, a tenth of
#   the 700 W limit: 70 W. Bound: [50, 100]. NVML's own reading refutes
#   it: an NVIDIA H100 80GB HBM3 at a 700 W limit read 118.56 W idle
#   fresh and 162.73 W idle after work (chip_smoke.py's study phase),
#   both above the bound.
# - Tensor cores (dense bf16 matmul): sustained dense GEMMs are what
#   drive the card to its power limit, so full duty adds 700 − 70 =
#   630 W. Bound: [500, 650]; the low end allows matmuls that run below
#   the limit.
# - HBM (memory streaming): HBM3 reads cost about 3–5 pJ/bit with the
#   PHY, 80–134 W at the 3.35 TB/s stream; the L2, the crossbar and the
#   load-issuing SMs roughly double the DRAM-only energy in published
#   accelerator power breakdowns: 200 W. Bound: [120, 280].
# - CUDA cores (elementwise and convert work): the FP32 cores' full rate
#   is a fifteenth of the tensor cores' FLOPs, at several pJ an operation
#   with register-file and issue energy: 200 W. Bound: [100, 300].
H100_IDLE_W = 70.0
H100_TENSOR_ACTIVE_W = 630.0
H100_HBM_ACTIVE_W = 200.0
H100_CUDA_CORE_ACTIVE_W = 200.0
H100_IDLE_W_BOUNDS = (50.0, 100.0)
H100_TENSOR_ACTIVE_W_BOUNDS = (500.0, 650.0)
H100_HBM_ACTIVE_W_BOUNDS = (120.0, 280.0)
H100_CUDA_CORE_ACTIVE_W_BOUNDS = (100.0, 300.0)

_NVML_SUCCESS = 0


class NvmlError(RuntimeError):
    """NVML is absent, or a call into it failed."""


def _load() -> ctypes.CDLL:
    """Open NVML (``NVML_LIB``, read at call time) and initialise it
    (``nvmlInit_v2``; repeated calls are reference-counted by the
    library)."""
    try:
        lib = ctypes.CDLL(NVML_LIB)
    except OSError as exc:
        raise NvmlError(f"cannot load {NVML_LIB}: {exc}") from None
    lib.nvmlErrorString.restype = ctypes.c_char_p
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    _check(lib, lib.nvmlInit_v2(), "nvmlInit_v2")
    return lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != _NVML_SUCCESS:
        message = lib.nvmlErrorString(rc)
        raise NvmlError(f"{what}: {message.decode() if message else rc}")


def format_pci_bus_id(domain: int, bus: int, device: int) -> str:
    """NVML's form of a PCI bus id, ``dddddddd:bb:dd.0``."""
    return f"{domain:08x}:{bus:02x}:{device:02x}.0"


def cuda_pci_bus_id() -> str:
    """The PCI bus id of the current CUDA device, the one the engine runs
    on."""
    import torch

    if not torch.cuda.is_available():
        raise NvmlError("no CUDA device in this process")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return format_pci_bus_id(props.pci_domain_id, props.pci_bus_id, props.pci_device_id)


class NvmlDevice:
    """One GPU as NVML sees it."""

    def __init__(self, lib: ctypes.CDLL, handle: ctypes.c_void_p) -> None:
        self._lib = lib
        self._handle = handle

    def total_energy_mj(self) -> int:
        """Millijoules the card has used since its kernel module loaded."""
        out = ctypes.c_ulonglong()
        _check(self._lib, self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(out)), "nvmlDeviceGetTotalEnergyConsumption")
        return int(out.value)

    def power_w(self) -> float:
        out = ctypes.c_uint()
        _check(self._lib, self._lib.nvmlDeviceGetPowerUsage(self._handle, ctypes.byref(out)),
               "nvmlDeviceGetPowerUsage")
        return out.value / 1000.0

    def power_limit_w(self) -> float:
        out = ctypes.c_uint()
        _check(self._lib, self._lib.nvmlDeviceGetEnforcedPowerLimit(
            self._handle, ctypes.byref(out)), "nvmlDeviceGetEnforcedPowerLimit")
        return out.value / 1000.0

    def name(self) -> str:
        buf = ctypes.create_string_buffer(96)
        _check(self._lib, self._lib.nvmlDeviceGetName(self._handle, buf, len(buf)),
               "nvmlDeviceGetName")
        return buf.value.decode()


def all_devices() -> List[NvmlDevice]:
    """Every device NVML sees, in its own order (the probe's view of the
    host)."""
    lib = _load()
    count = ctypes.c_uint()
    _check(lib, lib.nvmlDeviceGetCount_v2(ctypes.byref(count)), "nvmlDeviceGetCount_v2")
    devices = []
    for i in range(count.value):
        handle = ctypes.c_void_p()
        _check(lib, lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(i), ctypes.byref(handle)),
               f"nvmlDeviceGetHandleByIndex_v2({i})")
        devices.append(NvmlDevice(lib, handle))
    return devices


def nvml_device() -> NvmlDevice:
    """The NVML device behind the current CUDA device."""
    lib = _load()
    bus_id = cuda_pci_bus_id()
    handle = ctypes.c_void_p()
    _check(lib, lib.nvmlDeviceGetHandleByPciBusId_v2(bus_id.encode(), ctypes.byref(handle)),
           f"nvmlDeviceGetHandleByPciBusId_v2({bus_id})")
    return NvmlDevice(lib, handle)


class NvmlEnergyProfiler(SamplingProfiler):
    """The card's measured energy over the window, from NVML.

    ``source`` injects a device-like reader (``total_energy_mj()`` and
    ``power_w()``; tests, other platforms); by default the profiler opens
    NVML on first use and finds the current CUDA device, the engine's, by
    its PCI bus id. ``available`` is False when the library or the device
    is absent or its energy counter does not read; the columns are then
    None."""

    data_columns = ("gpu_energy_J", "gpu_avg_power_W")
    artifact_name = "gpu_power"
    measured_channel = True

    def __init__(self, period_s: float = 0.1, source: Optional[Any] = None) -> None:
        super().__init__(period_s=period_s)
        self._source = source
        self._opened = source is not None
        self.unavailable_reason: Optional[str] = None
        self._e0: Optional[int] = None
        self._e1: Optional[int] = None

    def device(self) -> Optional[Any]:
        """The reader, opened on first use; None when NVML or the device
        is absent (the reason in ``unavailable_reason``)."""
        if not self._opened:
            self._opened = True
            try:
                self._source = nvml_device()
            except NvmlError as exc:
                self.unavailable_reason = str(exc)
        return self._source

    def _energy_mj(self) -> Optional[int]:
        dev = self.device()
        if dev is None:
            return None
        try:
            return dev.total_energy_mj()
        except NvmlError as exc:
            self.unavailable_reason = str(exc)
            return None

    @property
    def available(self) -> bool:
        return self._energy_mj() is not None

    def on_start(self, context: RunContext) -> None:
        self._e1 = None
        self._e0 = self._energy_mj()
        super().on_start(context)

    def on_stop(self, context: RunContext) -> None:
        super().on_stop(context)
        self._e1 = self._energy_mj()

    def sample(self) -> Dict[str, Any]:
        dev = self.device()
        if dev is None:
            return {"power_W": None}
        try:
            return {"power_W": dev.power_w()}
        except NvmlError:
            return {"power_W": None}

    def summarise(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        if self._e0 is None or self._e1 is None:
            return {"gpu_energy_J": None, "gpu_avg_power_W": None}
        watts = [s["power_W"] for s in samples if s.get("power_W") is not None]
        span = samples[-1]["t_s"] - samples[0]["t_s"] if len(samples) > 1 else 0.0
        if len(watts) > 1 and span > 0:
            mean_w = integrate_power_to_joules(samples, "power_W") / span
        else:
            mean_w = watts[0] if watts else None
        return {
            "gpu_energy_J": round((self._e1 - self._e0) / 1000.0, 4),
            "gpu_avg_power_W": round(mean_w, 3) if mean_w is not None else None,
        }


class GpuEnergyModelProfiler(Profiler):
    """Deterministic modelled energy from the run's generation stats.

    The workload puts ``{"flops", "bytes", "vpu_ops", "duration_s",
    "generated_tokens"}`` into ``context.scratch["generation_stats"]``
    before POPULATE_RUN_DATA (``experiments/llm_energy.py::
    generation_stats_from``). ``bytes`` (device-memory bytes over the
    window) and ``vpu_ops`` (the weight-unpack ops, CUDA-core work here)
    may be omitted (0).

    Power = idle + Σ engine duty × engine active W, clamped to the card's
    limit: the tensor cores' duty is FLOPs over the bf16 rate, HBM's is
    bytes over the memory rate, the CUDA cores' is unpack ops over the
    non-tensor rate, each capped at 1. ``gpu_util_est`` is the largest
    duty; ``gpu_power_model_W`` the per-device power the energy was billed
    at. The form and the clamp are the JAX package's TPU model's; only the
    constants are the H100's (see the block above).
    """

    data_columns = (
        "energy_model_J",
        "joules_per_token",
        "gpu_util_est",
        "gpu_power_model_W",
    )

    def __init__(
        self,
        peak_tflops: float = H100_PEAK_BF16_TFLOPS,
        peak_w: float = H100_PEAK_W,
        idle_w: float = H100_IDLE_W,
        n_chips: int = 1,
        spec_hbm_gbps: float = H100_SPEC_HBM_GBPS,
        cuda_core_ops_per_s: float = H100_CUDA_CORE_OPS_PER_S,
        tensor_active_w: float = H100_TENSOR_ACTIVE_W,
        hbm_active_w: float = H100_HBM_ACTIVE_W,
        cuda_core_active_w: float = H100_CUDA_CORE_ACTIVE_W,
    ) -> None:
        self.peak_flops = peak_tflops * 1e12
        self.peak_w = peak_w
        self.idle_w = idle_w
        self.n_chips = n_chips
        self.spec_hbm_bps = spec_hbm_gbps * 1e9
        self.cuda_core_ops_per_s = cuda_core_ops_per_s
        self.tensor_active_w = tensor_active_w
        self.hbm_active_w = hbm_active_w
        self.cuda_core_active_w = cuda_core_active_w
        self._t0 = 0.0
        self._window_s = 0.0

    def on_start(self, context: RunContext) -> None:
        self._t0 = time.monotonic()

    def on_stop(self, context: RunContext) -> None:
        self._window_s = time.monotonic() - self._t0

    def collect(self, context: RunContext) -> Dict[str, Any]:
        stats = context.scratch.get("generation_stats")
        if not stats:
            return {
                "energy_model_J": None,
                "joules_per_token": None,
                "gpu_util_est": None,
                "gpu_power_model_W": None,
            }
        duration = float(stats.get("duration_s") or self._window_s)
        flops = float(stats.get("flops", 0.0))
        hbm_bytes = float(stats.get("bytes", 0.0))
        cc_ops = float(stats.get("vpu_ops", 0.0))
        tokens = int(stats.get("generated_tokens", 0))
        peak = self.peak_flops * self.n_chips
        peak_bw = self.spec_hbm_bps * self.n_chips
        peak_cc = self.cuda_core_ops_per_s * self.n_chips
        if duration > 0:
            # per-engine duties, each capped at 1.0 (an engine cannot run
            # above its rate; an apparent duty above 1 means the rate is
            # conservative for that access pattern)
            tc_duty = min(flops / (peak * duration), 1.0)
            hbm_duty = min(hbm_bytes / (peak_bw * duration), 1.0)
            cc_duty = min(cc_ops / (peak_cc * duration), 1.0)
            util = max(tc_duty, hbm_duty, cc_duty)
        else:
            tc_duty = hbm_duty = cc_duty = util = 0.0
        power_w = min(
            self.idle_w
            + tc_duty * self.tensor_active_w
            + hbm_duty * self.hbm_active_w
            + cc_duty * self.cuda_core_active_w,
            self.peak_w,
        )
        energy = power_w * self.n_chips * duration
        return {
            "energy_model_J": round(energy, 4),
            "joules_per_token": round(energy / tokens, 4) if tokens else None,
            "gpu_util_est": round(util, 4),
            "gpu_power_model_W": round(power_w, 2),
        }
