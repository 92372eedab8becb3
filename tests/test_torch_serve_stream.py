"""The JAX package's ``tests/test_stream.py`` on the port's
``serve/stream.py``, scheduler, server and client, loaded with the
package name swapped. The cases that drive the real engine run on
``TorchEngine(device="cpu")`` at f32 with the JAX file's layouts:
cancelled pages return to the pool exactly, cancelled rows credit no
goodput (on the contiguous session, as in the JAX file; on the paged one
in ``tests/test_torch_serve_stream_paged.py``), and streamed tokens equal
buffered ones on all four layouts (contiguous and paged, bf16 and int8).
No case is left out."""

from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32, paged_kv=True)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu")'),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n        device="cpu",\n'),
)
CASES = load_cases(globals(), "test_stream.py", renames=RENAMES)


def test_every_stream_case_is_loaded():
    assert len(CASES) == 29
