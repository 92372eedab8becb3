"""The JAX package's ``tests/test_tenant_attribution.py`` on the port's
stepped session, fake backend and tenant accounting, loaded with the
package name swapped. The real-engine cases run on
``TorchEngine(device="cpu")`` at f32 with the JAX file's layouts: the
session's books balance (live + retired close-outs + dropped == totals,
to 1e-6) with a chunked joiner on all four layouts, a cancel and a close
on the contiguous session (on the paged one in
``tests/test_torch_serve_tenants_paged.py``), a join abort on the paged
one, and a preempt and resume by swap (paged) and by recompute
(contiguous). No case is left out."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n                device="cpu",\n'),
)
CASES = load_cases(globals(), "test_tenant_attribution.py", renames=RENAMES)


def test_every_tenant_attribution_case_is_loaded():
    assert len(CASES) == 15
