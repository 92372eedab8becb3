"""The JAX package's ``tests/test_slo.py`` on the port's ``obs/slo.py``:
every case, loaded with the package name swapped (no case left out)."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

CASES = load_cases(globals(), "test_slo.py")


def test_every_slo_case_is_loaded():
    assert len(CASES) == 11
