"""The JAX package's ``tests/test_scheduler.py`` on the port's
``serve/scheduler.py``, ``serve/server.py`` and ``engine/fake.py``:
every case, loaded with the package name swapped. The two cases that
drive the real engine (scheduler-level token parity, one-shot and
chunked joins) run on ``TorchEngine(device="cpu")`` at f32 on the
contiguous session, as in the JAX file, and their tokens must equal the
solo ``generate``'s just as the JAX engine's do; on the paged session in
``tests/test_torch_serve_scheduler_paged.py``. No case is left out."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu")'),
)
CASES = load_cases(globals(), "test_scheduler.py", renames=RENAMES)


def test_every_scheduler_case_is_loaded():
    assert len(CASES) == 23
