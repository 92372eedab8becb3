"""The JAX package's ``tests/test_radix_store.py`` on the port's
``engine/radix_store.py``, loaded with the package name swapped: the
radix tree's longest match and splits, the node cap, the device and host
byte budgets, spill and restore bit for bit on bf16 and int8 pools, the
session scope, shared pages released at detach, a paged hit whose pages
rebuild from the seed slab (a ``TorchEngine(device="cpu")`` session at
f32, tokens equal to solo ``generate``), and the bounded digest. The
store's slabs and blobs are CPU tensors, so the pool reads go through
``_np`` (numpy has no bfloat16). No case is left out."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
    ("jnp.asarray(pages, jnp.int32)", "torch.as_tensor(pages)"),
    ("jnp.asarray(", "torch.as_tensor("),
    ("PAGE = 128\n", "PAGE = 128\n\n\ndef _np(t):\n    return t.float().numpy()\n"),
    ("np.asarray(\n        pool.k", "_np(\n        pool.k"),
)
CASES = load_cases(globals(), "test_radix_store.py", renames=RENAMES)


def test_every_radix_store_case_is_loaded():
    assert len(CASES) == 12
