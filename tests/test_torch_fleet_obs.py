"""The JAX package's ``tests/test_fleet_obs.py`` on the port's router,
loaded with the package name swapped: the fleet-wide ``x_trace`` minted
or adopted at the front door and shared by a retried ticket's attempts,
``/debug/flight?trace=`` and the router's ``/debug/timeline``, the
``llm_fleet_*`` federation of the replicas' scrapes
(``merge_expositions``), and the retry's ``cause="retry"`` charge.

Left out: ``test_poisson_load_mints_traces_and_reports_them``, which
imports ``scripts/poisson_load.py``, whose port is ROADMAP item 18."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

LEFT_OUT = ("test_poisson_load_mints_traces_and_reports_them",)
CASES = load_cases(globals(), "test_fleet_obs.py", leave_out=LEFT_OUT)


def test_every_fleet_obs_case_is_loaded():
    assert len(CASES) == 14
