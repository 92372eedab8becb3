"""The JAX package's ``tests/test_migrate.py`` on the port's
``serve/migrate.py`` and replica router, loaded with the package name
swapped: the bundle codec (the fake kind's JSON round trip, the export
refusals, the version check); the seven ``Router`` / ``LocalReplica``
cases (a decode-only fleet refuses fresh work, fresh work never lands on
a decode replica, role validation, the disaggregated fleet's exact
parity and attribution, a dead receiver falling back to decode on the
source, drain with migration continuing a stream from its cursor, a
speculating prime decaying to a local stream); and the real engine at
session level, over ``TorchEngine(device="cpu")`` at f32: a row
preempted on one engine, shipped through the JSON wire codec and seated
on another engine's session (or back on its source, when the receiver
dies) finishes with its solo tokens on all four cache layouts, with
both pools' free counts restored."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
)
ONLY = (
    "test_fake_bundle_json_roundtrip",
    "test_export_refuses_shared_prefix_and_spec_rows",
    "test_import_rejects_unknown_version",
    "test_decode_only_fleet_refuses_fresh_work",
    "test_fresh_work_never_lands_on_decode_replica",
    "test_replica_role_validation",
    "test_disagg_fleet_exact_parity_and_attribution",
    "test_receiver_death_falls_back_to_source_local_decode",
    "test_drain_migrate_evacuates_mid_stream_cursor_survives",
    "test_spec_active_prime_decays_to_local_stream",
    "test_real_migrate_token_parity_all_layouts",
    "test_real_receiver_failure_falls_back_to_source_seat",
)
CASES = load_cases(globals(), "test_migrate.py", renames=RENAMES, only=ONLY)


def test_the_codec_and_real_engine_cases_are_loaded():
    assert CASES == list(ONLY)
