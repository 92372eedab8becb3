"""The served cases of the JAX package's ``tests/test_flight.py`` on the
port, loaded with the package name swapped: a poisoned window batch
leaves a crash dump, ``/debug/state`` and ``/debug/flight`` serve the
live state and events (and refuse a bad ``n``, and 404 under the kill
switch, where a served request emits no event), and the goodput counters
move from a stepped session, on the fake backend and on
``TorchEngine(device="cpu")`` (``engines_on_the_cpu``).
``tests/test_torch_obs_energy.py`` runs the file's other eighteen cases.
"""

from test_torch_runner import engines_on_the_cpu  # noqa: F401  (TorchEngine on the CPU)
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (("engine.jax_engine", "engine.torch_engine"), ("JaxEngine", "TorchEngine"))
ONLY = (
    "test_poisoned_window_batch_leaves_crash_dump",
    "test_debug_endpoints_serve_live_state_and_events",
    "test_debug_flight_rejects_bad_n",
    "test_debug_endpoints_404_when_disabled",
    "test_kill_switch_served_request_emits_no_events",
    "test_goodput_counters_from_stepped_session",
    "test_goodput_counters_real_engine_stepped",
)
CASES = load_cases(globals(), "test_flight.py", renames=RENAMES, only=ONLY)
