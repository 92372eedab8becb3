"""The JAX package's ``tests/test_scheduler.py`` on the port's
``serve/scheduler.py``, ``serve/server.py`` and ``engine/fake.py``:
every case, loaded with the package name swapped. The two cases that
drive the real engine (scheduler-level token parity, one-shot and
chunked joins) run on ``TorchEngine(device="cpu", paged_kv=True)`` at
f32: the port's stepped session is the paged one (the contiguous
session is not ported), and its tokens must equal the solo
``generate``'s just as the JAX engine's do. No case is left out."""

from test_torch_runner import load_cases

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
)
CASES = load_cases(globals(), "test_scheduler.py", renames=RENAMES)


def test_every_scheduler_case_is_loaded():
    assert len(CASES) == 23
