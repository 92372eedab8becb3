"""The JAX package's ``tests/test_spec_sampled.py`` on the port's
speculating session, loaded with the package name swapped, over
``TorchEngine(device="cpu")`` at f32 with the JAX file's layouts
(contiguous and paged, bf16 and int8 KV): at temperature 0.7 the pooled
tokens of a speculating session pass the file's chi-squared and TV tests
against the plain session's for the model, n-gram and cross sources (the
port's random streams are its own, so sampled rows match in
distribution); at temperature 0 every source gives plain greedy tokens;
``spec_draft_temperature`` keeps the marginals; a sampled joiner inherits
the n-gram config; a sampled speculating row preempted by swap or
recompute and resumed gives an uninterrupted run's tokens; ``generate``
routes sampled requests through a one-row session.
``test_sampled_spec_matches_plain_distribution`` runs in
``tests/test_torch_spec_sampled_{contig,paged}_{bf16,int8}.py``, one
layout a file, so that each file stays short.

Left out: ``test_tp_sampled_spec_carry_leaves_stable``, the tensor-parallel
session on 2 and 8 devices, which reads the JAX carry's shardings: its
counterpart on the port's sharded engine is in
``tests/test_torch_stepped_tp.py``."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
)
LEFT_OUT = ("test_tp_sampled_spec_carry_leaves_stable", "test_sampled_spec_matches_plain_distribution")
CASES = load_cases(globals(), "test_spec_sampled.py", renames=RENAMES, leave_out=LEFT_OUT)


def test_every_spec_sampled_case_is_loaded():
    assert len(CASES) == 5
