"""The cases of the JAX package's ``tests/test_stepped.py`` that run on
its default (contiguous) engine, loaded a second time onto
``TorchEngine(device="cpu", paged_kv=True)`` at f32, so that the port's
paged session keeps them too: rows retire early, a joiner mid-flight, the
join refusals, mixed sampling knobs, a budget-one row, a one-chunk
chunked join against the one-shot join, and the open's input checks.
``tests/test_torch_serve_stepped.py`` loads the whole file with its own
layouts."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
    ("dtype=jnp.float32, paged_kv=True\n", 'dtype=torch.float32, device="cpu", paged_kv=True\n'),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n        device="cpu",\n'),
)
ONLY = (
    "test_stepped_matches_solo_and_retires_early",
    "test_stepped_join_mid_flight_is_solo_identical",
    "test_stepped_join_refuses_incompatible",
    "test_stepped_mixed_sampling_knobs_parity",
    "test_stepped_budget_one_row_retires_with_prefill_token",
    "test_chunked_join_single_chunk_matches_sync_join",
    "test_stepped_validates_inputs",
)
CASES = load_cases(globals(), "test_stepped.py", renames=RENAMES, only=ONLY)


def test_every_paged_copy_is_loaded():
    assert sorted(CASES) == sorted(ONLY)
