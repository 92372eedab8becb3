"""The JAX package's ``tests/test_slo.py`` on the port's ``obs/slo.py``:
every case, loaded with the package name swapped (no case left out)."""

from test_torch_runner import load_cases

CASES = load_cases(globals(), "test_slo.py")


def test_every_slo_case_is_loaded():
    assert len(CASES) == 11
