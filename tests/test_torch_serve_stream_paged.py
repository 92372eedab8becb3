"""The case of the JAX package's ``tests/test_stream.py`` that runs on
its default (contiguous) engine, ``test_cancelled_rows_never_credit_goodput``,
loaded a second time onto ``TorchEngine(device="cpu", paged_kv=True)`` at
f32, so that the port's paged session keeps it too.
``tests/test_torch_serve_stream.py`` loads the whole file with its own
layouts."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
)
ONLY = ("test_cancelled_rows_never_credit_goodput",)
CASES = load_cases(globals(), "test_stream.py", renames=RENAMES, only=ONLY)


def test_every_paged_copy_is_loaded():
    assert CASES == list(ONLY)
