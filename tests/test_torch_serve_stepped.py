"""The JAX package's ``tests/test_stepped.py`` on the port's stepped
session, loaded with the package name swapped, over
``TorchEngine(device="cpu", paged_kv=True)`` at f32: rows retire early
and free their pages mid-flight, joiners (one-shot and chunked) and
mixed sampling knobs keep every row equal to its solo ``generate``, the
admission probes refuse what does not fit, and a close frees the pool.

Left out, as parametrizations: the contiguous layouts of
``test_stepped_int8_kv_parity_with_join`` (``paged=False``) and of
``test_chunked_join_parity_all_layouts`` (``contig-bf16``,
``contig-int8``), because the port's session is the paged one (the
contiguous session is ROADMAP item 11.2). Left out as a case:
``test_can_join_rejects_prompt_over_session_bucket``, which pins the
contiguous session's row cache (``cache_len``); the paged session's
admission probe (pages, ``jmax``, the side caches' ``g_bucket``) is
``test_can_join_rejects_when_pool_drained`` here and the refusals in
``tests/test_torch_serving.py``. The cases that the JAX file runs on its
contiguous session run on the paged one."""

from test_torch_runner import load_cases

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32)", 'dtype=torch.float32, device="cpu", paged_kv=True)'),
    ("dtype=jnp.float32, paged_kv=True\n", 'dtype=torch.float32, device="cpu", paged_kv=True\n'),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n        device="cpu",\n'),
    ('@pytest.mark.parametrize("paged", [False, True])', '@pytest.mark.parametrize("paged", [True])'),
    (
        '[(False, None), (False, "int8"), (True, None), (True, "int8")],\n'
        '    ids=["contig-bf16", "contig-int8", "paged-bf16", "paged-int8"],',
        '[(True, None), (True, "int8")],\n    ids=["paged-bf16", "paged-int8"],',
    ),
)
LEFT_OUT = ("test_can_join_rejects_prompt_over_session_bucket",)
CASES = load_cases(globals(), "test_stepped.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_stepped_case_is_loaded():
    assert len(CASES) == 14
