"""The JAX package's ``tests/test_stream.py`` on the port's
``serve/stream.py``, scheduler, server and client, loaded with the
package name swapped. The cases that drive the real engine run on
``TorchEngine(device="cpu")`` at f32 with ``paged_kv=True``: cancelled
pages return to the pool exactly, cancelled rows credit no goodput, and
streamed tokens equal buffered ones on the bf16 and int8 pools.

Left out: the two contiguous-cache layouts of
``test_stream_matches_buffered_all_layouts`` (``contig-bf16`` and
``contig-int8``), because the port's stepped session is the paged one
(the contiguous session is ROADMAP item 11.2); the two paged layouts
run."""

from test_torch_runner import load_cases

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32, paged_kv=True)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n        device="cpu",\n'),
    (
        '[(False, None), (False, "int8"), (True, None), (True, "int8")],\n'
        '    ids=["contig-bf16", "contig-int8", "paged-bf16", "paged-int8"],',
        '[(True, None), (True, "int8")],\n    ids=["paged-bf16", "paged-int8"],',
    ),
)
CASES = load_cases(globals(), "test_stream.py", renames=RENAMES)


def test_every_stream_case_is_loaded():
    assert len(CASES) == 29
