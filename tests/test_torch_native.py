"""The port's native host sampler against the JAX package's tests.

The five cases of ``tests/test_native.py`` run on the port's
``native/`` and ``profilers/native_host.py`` (the file's source with the
package name swapped): the library builds with g++ into the port's
``_build/native/`` and is cached, the raw sampler round-trips, bad
arguments are refused, and the profiler collects and is reusable across
runs. Then the port's library is held beside the JAX package's: the same
source and flags, built apart.
"""

import pytest

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.native import build as jax_build
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.native import build
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.profilers import native_host
from test_torch_runner import PORT, port_module, run_case
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

NATIVE = port_module("test_native.py")
CASES = sorted(n for n in vars(NATIVE) if n.startswith("test_") and callable(getattr(NATIVE, n)))


def test_every_jax_native_case_is_loaded():
    assert len(CASES) == 5


@pytest.mark.parametrize("name", CASES)
def test_jax_native_case_on_the_port(name, request):
    if NATIVE.lib is None:
        pytest.skip("no native toolchain")
    assert NATIVE.NativeHostProfiler is native_host.NativeHostProfiler
    run_case(getattr(NATIVE, name), request)


def test_the_port_builds_the_same_source_into_its_own_directory():
    assert build._SOURCE.read_bytes() != b"" and build._FLAGS == jax_build._FLAGS
    assert build._BUILD_DIR.parts[-3:] == (PORT, "_build", "native")
    assert build._BUILD_DIR != jax_build._BUILD_DIR
    if NATIVE.lib is None:
        pytest.skip("no native toolchain")
    assert any(build._BUILD_DIR.glob("sampler-*.so"))


@pytest.mark.parametrize("advance", [0.0, 400.0])
def test_cpu_usage_is_none_when_proc_stat_does_not_advance(advance):
    # The window-edge snapshots: [t_s, energy_uj, cpu_busy, cpu_total,
    # mem_avail_kb]. A /proc/stat frozen over the window measured no CPU
    # time, so cpu_usage stays empty (the JAX profiler writes 0.0 there);
    # one that advanced gives busy over total.
    prof = native_host.NativeHostProfiler()
    prof._handle = 1  # as if the library had started; nothing is called on it
    prof._rows = []
    prof._start_snap = [0.0, -1.0, 100.0, 1000.0, -1.0]
    prof._stop_snap = [1.0, -1.0, 100.0 + advance / 4, 1000.0 + advance, -1.0]
    data = prof.collect(None)
    prof._handle = None
    assert data["cpu_usage"] == (None if advance == 0 else 25.0)
    assert data["host_energy_J"] is None and data["memory_usage"] is None
