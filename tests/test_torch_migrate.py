"""The JAX package's ``tests/test_migrate.py`` on the port's
``serve/migrate.py``, loaded with the package name swapped: the bundle
codec (the fake kind's JSON round trip, the export refusals, the version
check) and the real engine at session level, over
``TorchEngine(device="cpu")`` at f32: a row preempted on one engine,
shipped through the JSON wire codec and seated on another engine's
session (or back on its source, when the receiver dies) finishes with
its solo tokens on all four cache layouts, with both pools' free counts
restored.

Left out until the replica router is ported (ROADMAP item 15): the seven
``Router`` / ``LocalReplica`` cases
(``test_decode_only_fleet_refuses_fresh_work``,
``test_fresh_work_never_lands_on_decode_replica``,
``test_replica_role_validation``,
``test_disagg_fleet_exact_parity_and_attribution``,
``test_receiver_death_falls_back_to_source_local_decode``,
``test_drain_migrate_evacuates_mid_stream_cursor_survives``,
``test_spec_active_prime_decays_to_local_stream``). Their assertions are
checked by hand over two port servers in
``tests/test_torch_migrate_serving.py``."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
    (
        "from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve import (\n"
        "    router as router_mod,\n)\n",
        "",
    ),
    (
        "from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.router import (\n"
        "    LocalReplica,\n    Router,\n)\n",
        "",
    ),
)
ONLY = (
    "test_fake_bundle_json_roundtrip",
    "test_export_refuses_shared_prefix_and_spec_rows",
    "test_import_rejects_unknown_version",
    "test_real_migrate_token_parity_all_layouts",
    "test_real_receiver_failure_falls_back_to_source_seat",
)
CASES = load_cases(globals(), "test_migrate.py", renames=RENAMES, only=ONLY)


def test_the_codec_and_real_engine_cases_are_loaded():
    assert CASES == list(ONLY)
