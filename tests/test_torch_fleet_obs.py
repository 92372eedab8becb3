"""The JAX package's ``tests/test_fleet_obs.py`` on the port's router,
loaded with the package name swapped: the fleet-wide ``x_trace`` minted
or adopted at the front door and shared by a retried ticket's attempts,
``/debug/flight?trace=`` and the router's ``/debug/timeline``, the
``llm_fleet_*`` federation of the replicas' scrapes
(``merge_expositions``), the retry's ``cause="retry"`` charge, and the
load generator's caller-minted traces, read from the port's
``scripts/torch_poisson_load.py`` in place of ``scripts/poisson_load.py``."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (('"poisson_load.py"', '"torch_poisson_load.py"'),)
CASES = load_cases(globals(), "test_fleet_obs.py", renames=RENAMES)


def test_every_fleet_obs_case_is_loaded():
    assert len(CASES) == 15
