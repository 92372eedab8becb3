"""The two real-engine cases of the JAX package's
``tests/test_scheduler.py`` (the continuous scheduler's tokens equal
the solo ``generate``'s, with one-shot and with chunked joins), loaded a
second time onto ``TorchEngine(device="cpu", paged_kv=True)`` at f32, so
that the port's paged session keeps them too.
``tests/test_torch_serve_scheduler.py`` loads the whole file on the
contiguous session, as the JAX file runs it."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
)
ONLY = (
    "test_continuous_scheduler_with_jax_engine_matches_solo",
    "test_continuous_chunked_join_with_jax_engine_matches_solo",
)
CASES = load_cases(globals(), "test_scheduler.py", renames=RENAMES, only=ONLY)


def test_every_paged_copy_is_loaded():
    assert sorted(CASES) == sorted(ONLY)
