"""The JAX package's ``tests/test_serve.py`` on the port's
``serve/server.py``, client and study config, loaded with the package
name swapped. Its paged-batching case runs on
``TorchEngine(device="cpu", paged_kv=True)`` at f32, each response held
against a solo ``generate``.

Left out: ``test_concurrent_requests_served_through_grouped_prefill``,
which counts grouped prefills by wrapping the JAX engine's compiled
prefill function (``_prefill_fn``), a function the port does not have
(its grouped prefill is one ``forward`` call inside ``_batch_states``,
held against the JAX engine token for token in
``tests/test_torch_batch_engine.py``)."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32, paged_kv=True)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
)
LEFT_OUT = ("test_concurrent_requests_served_through_grouped_prefill",)
CASES = load_cases(globals(), "test_serve.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_serve_case_is_loaded():
    assert len(CASES) == 31
