"""The JAX package's ``tests/test_tenant_attribution.py`` on the port's
stepped session, fake backend and tenant accounting, loaded with the
package name swapped. The real-engine cases run on
``TorchEngine(device="cpu")`` at f32 over the paged pool: the session's
books balance (live + retired close-outs + dropped == totals, to 1e-6)
with a chunked joiner, a cancel, a join abort, a swap preempt and
resume, and a close, on the bf16 and int8 pools.

Left out, as parametrizations: the contiguous layouts (``contig-bf16``,
``contig-int8``, ``contig-recompute``), because the port's session is
the paged one (the contiguous session is ROADMAP item 11.2, and a
stacked session refuses ``recompute`` in both packages). The cancel
and close cases, which the JAX file runs on the contiguous session,
run on the paged one."""

from test_torch_runner import load_cases

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32,\n", 'dtype=torch.float32,\n                device="cpu",\n'),
    (
        '[(False, None), (False, "int8"), (True, None), (True, "int8")],\n'
        '    ids=["contig-bf16", "contig-int8", "paged-bf16", "paged-int8"],',
        '[(True, None), (True, "int8")],\n    ids=["paged-bf16", "paged-int8"],',
    ),
    (
        '[(True, None, "swap"), (False, None, "recompute")],\n'
        '    ids=["paged-swap", "contig-recompute"],',
        '[(True, None, "swap")],\n    ids=["paged-swap"],',
    ),
    ("eng = engines(False, None)", "eng = engines(True, None)"),
)
CASES = load_cases(globals(), "test_tenant_attribution.py", renames=RENAMES)


def test_every_tenant_attribution_case_is_loaded():
    assert len(CASES) == 15
