"""The JAX package's ``tests/test_speculative.py`` on the port, loaded with
the package name swapped, over ``TorchEngine(device="cpu")`` at f32 on the
engine's default contiguous layout: the solo greedy loop equals plain
greedy decode (a foreign draft, a self-draft that accepts everything),
``generate`` routes greedy and sampled requests to speculation (a sampled
one drains a one-row contiguous session), budgets and EOS are kept,
accepted drafts count only what was emitted, and a vocabulary mismatch,
a repeat penalty, a draft that cannot be resident beside its target and
a margin past ``max_seq_len`` are refused or served plain. No case is
left out."""

from test_torch_runner import load_cases, one_torch_thread  # noqa: F401

RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp", "import torch"),
    ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"'),
)
CASES = load_cases(globals(), "test_speculative.py", renames=RENAMES)


def test_every_speculative_case_is_loaded():
    assert len(CASES) == 10
