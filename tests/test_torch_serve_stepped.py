"""The JAX package's ``tests/test_stepped.py`` on the port's stepped
session, loaded with the package name swapped, over
``TorchEngine(device="cpu")`` at f32 with the JAX file's layouts: the
contiguous session where the JAX file runs it (its default engine,
``paged=False``, the ``contig-*`` layouts, and the row-cache admission
probe of ``test_can_join_rejects_prompt_over_session_bucket``), the
paged one where it asks for ``paged_kv=True``. Rows retire early (and
free their pages mid-flight), joiners (one-shot and chunked) and mixed
sampling knobs keep every row equal to its solo ``generate``, the
admission probes refuse what does not fit, and a close frees the pool.
The cases that the JAX file runs on its contiguous session run on the
paged one as well in ``tests/test_torch_serve_stepped_paged.py``. No
case is left out."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu")'),
    ("dtype=jnp.float32, paged_kv=True\n", 'dtype=torch.float32, device="cpu", paged_kv=True\n'),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n        device="cpu",\n'),
)
CASES = load_cases(globals(), "test_stepped.py", renames=RENAMES)


def test_every_stepped_case_is_loaded():
    assert len(CASES) == 15
