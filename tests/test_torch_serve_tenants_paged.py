"""The cases of the JAX package's ``tests/test_tenant_attribution.py``
that run on its contiguous session (a cancel moves the row's account to
the dropped books; a close abandons the live rows), loaded a second time
with the paged session (``engines(True, None)``:
``TorchEngine(device="cpu", paged_kv=True)`` at f32), so that the port's
paged session keeps them too. ``tests/test_torch_serve_tenants.py``
loads the whole file with its own layouts."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n                device="cpu",\n'),
    ("eng = engines(False, None)", "eng = engines(True, None)"),
)
ONLY = ("test_conservation_cancel_moves_account_to_dropped", "test_conservation_close_abandons_live_rows")
CASES = load_cases(globals(), "test_tenant_attribution.py", renames=RENAMES, only=ONLY)


def test_every_paged_copy_is_loaded():
    assert sorted(CASES) == sorted(ONLY)
